"""BM25 first-stage retrieval on the port (counterpart of `sgpt_tpu/cli/bm25_retriever.py`).

    python -m sgpt_tpu_torch.cli.bm25_retriever --dataset scifact \\
        --datadir ./datasets --topk 1000

The JAX CLI's flags. Runs the self-contained Okapi BM25 index
(`retrieval_bm25.py`, host only, no external service) and writes the
first-stage json `{qid: {docid: score}}` that `sgptce --bm25results` reads
(default `./results_<dataset>.json`), then logs BM25's nDCG.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from .common import setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scifact")
    p.add_argument("--datadir", default="./datasets")
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--k1", type=float, default=1.2)
    p.add_argument("--b", type=float, default=0.75)
    p.add_argument("--output", default=None,
                   help="default: ./results_<dataset>.json (the notebook's name)")
    p.add_argument("--overwrite", action="store_true")
    return p.parse_args(argv)


def main(args=None):
    setup_logging()
    args = args or parse_args()

    from ..evaluation import EvaluateRetrieval, load_beir_dataset
    from ..retrieval_bm25 import BM25Retriever

    out = args.output or f"./results_{args.dataset.replace('/', '_')}.json"
    if os.path.exists(out) and not args.overwrite:
        logger.info("Found %s - Skipping ...", out)
        return None

    data_path = os.path.join(args.datadir, args.dataset)
    split = "dev" if args.dataset == "msmarco" else "test"
    corpus, queries, qrels = load_beir_dataset(data_path, split)
    logger.info("%d docs, %d queries", len(corpus), len(queries))

    k_values = [k for k in (1, 3, 5, 10, 100, 1000) if k <= args.topk]
    if args.topk not in k_values:
        # retrieval depth = max(k_values): honour a non-standard --topk
        k_values.append(args.topk)
    retriever = EvaluateRetrieval(BM25Retriever(k1=args.k1, b=args.b), k_values=k_values)
    results = retriever.retrieve(corpus, queries)  # top_k = max k_value
    with open(out, "w") as f:
        json.dump(results, f)
    logger.info("wrote %s", out)

    ndcg, _map, recall, precision = retriever.evaluate(qrels, results, retriever.k_values)
    logger.info("BM25 nDCG: %s", ndcg)
    return ndcg


if __name__ == "__main__":
    main()
