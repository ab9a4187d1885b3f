"""BEIR bi-encoder evaluation on the PyTorch port (counterpart of `sgpt_tpu/cli/beir_retriever.py`).

    python -m sgpt_tpu_torch.cli.beir_retriever --modelname EleutherAI/gpt-neo-125M \\
        --dataset scifact --method weightedmean --specb --maxseqlen 300 \\
        --randominit --device cuda

The JAX CLI's flags less `--dp`/`--tp` (meshes: ROADMAP Queue 1 item
12), plus `--device`. Writes the same `./results_<model>_<method>_<dataset>.json`
and `./beir_embeddings_ndcgs.json` entries. `--layeridx` pools the states
of one layer (0: the embeddings, -1: the final states), for the layer
sweeps of the reference:

    for L in 0 4 8 12; do python -m sgpt_tpu_torch.cli.beir_retriever \
        --dataset scifact --layeridx $L --randominit --overwrite; done

Not ported yet, and raising: `--quantize` (item 9).
`--modelname` is a preset with `--randominit` (GPT-Neo; "6b"/"5.8b"/"6.1b":
GPT-J-6B; "bloom": BLOOM-1b7) or a local HF checkpoint directory.
`--download` fetches the dataset only when passed.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from .common import build_model, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--modelname", default="EleutherAI/gpt-neo-125M")
    p.add_argument("--dataset", default="scifact")
    p.add_argument("--datapath", default="./datasets")
    p.add_argument("--download", action="store_true",
                   help="fetch the BEIR dataset zip if --datapath/<dataset> "
                        "is missing (egress-gated: off by default)")
    p.add_argument("--method", default="weightedmean",
                   choices=["mean", "meanmean", "weightedmean", "lasttoken",
                            "lasttokenmean"])
    p.add_argument("--layeridx", type=int, default=-1)
    p.add_argument("--specb", action="store_true")
    p.add_argument("--maxseqlen", type=int, default=None)
    p.add_argument("--batchsize", type=int, default=32)
    p.add_argument("--saveemb", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--computeavg", action="store_true")
    p.add_argument("--selectbest", action="store_true")
    p.add_argument("--randominit", action="store_true",
                   help="random weights (smoke/debug; reference --reinit)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="int8 decoder projections (not ported yet: ROADMAP Queue 1 item 9)")
    p.add_argument("--topk", type=int, default=1000)
    p.add_argument("--expect-ndcg", type=float, default=None, dest="expect_ndcg",
                   help="assert nDCG@10 >= this value minus --ndcg-tol (exit 1 otherwise)")
    p.add_argument("--ndcg-tol", type=float, default=0.005, dest="ndcg_tol")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode and search on: cuda (the kernels) "
                   "or cpu (their plain versions)")
    return p.parse_args(argv)


def main(args=None):
    setup_logging()
    args = args or parse_args()
    if args.quantize:
        raise NotImplementedError("--quantize: int8 inference is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")

    from ..evaluation.aggregate import ResultsStore
    store = ResultsStore()
    if args.computeavg:
        store.compute_model_avg()
        store.save()
        return
    if args.selectbest:
        best = store.select_best_ckpt()
        with open("./beir_embeddings_best_ndcgs.json", "w") as f:
            json.dump({"ndcgs": best}, f)
        return

    from ..encoder import EmbeddingEngine
    from ..evaluation import EvaluateRetrieval, load_beir_dataset
    from ..retrieval import DenseRetriever

    data_path = os.path.join(args.datapath, args.dataset)
    if args.download and not os.path.isdir(data_path):
        # egress-gated: nothing fetches unless this flag is passed explicitly
        from ..baselines import fetch_beir_dataset
        fetch_beir_dataset(args.dataset, out_dir=args.datapath)
    split = "dev" if args.dataset == "msmarco" else "test"
    corpus, queries, qrels = load_beir_dataset(data_path, split)

    try:
        model, cfg, tokenizer = build_model(args.modelname, random_init=args.randominit,
                                            dtype_str=args.dtype, device=args.device)
    except Exception as e:
        if args.expect_ndcg is not None:
            # exit 3: weights unavailable (rerun when they land), not a score mismatch
            logger.error("score-parity UNAVAILABLE: cannot build %s (%r)", args.modelname, e)
            raise SystemExit(3) from e
        raise
    engine = EmbeddingEngine(
        model, cfg, tokenizer, device=args.device, method=args.method, specb=args.specb,
        layeridx=args.layeridx, max_seq_len=args.maxseqlen, batch_size=args.batchsize,
        cache_dir=(f"embeddings/{args.modelname.split('/')[-1]}/"
                   f"{args.method}/{args.dataset}" if args.saveemb else None))

    model_name = args.modelname.replace("/", "_")
    dataset = args.dataset.replace("/", "_")
    out_path = f"./results_{model_name}_{args.method}_{dataset}.json"
    expect = args.expect_ndcg
    if os.path.exists(out_path) and not args.overwrite and expect is None:
        logger.info("Found %s - Skipping ...", out_path)
        return

    topk = args.topk
    if expect is not None:
        topk = max(topk, 10)  # the assertion reads nDCG@10
    retriever = EvaluateRetrieval(DenseRetriever(engine),
                                  k_values=[k for k in (1, 3, 5, 10, 100, 1000)
                                            if k <= topk])
    if os.path.exists(out_path) and not args.overwrite:
        logger.info("Found %s - evaluating existing results", out_path)
        with open(out_path) as f:
            results = json.load(f)
    else:
        results = retriever.retrieve(corpus, queries)
        with open(out_path, "w") as f:
            json.dump(results, f)

    ndcg, _map, recall, precision = retriever.evaluate(qrels, results, retriever.k_values)
    logger.info("nDCG: %s", ndcg)
    store.add(model_name, dataset, ndcg, _map, recall, precision)
    store.save()

    if expect is not None:
        got = ndcg.get("NDCG@10")
        if got is None or got < expect - args.ndcg_tol:
            raise SystemExit(
                f"score-parity FAILED: nDCG@10={got} < expected "
                f"{expect} (tol {args.ndcg_tol})")
        logger.info("score-parity OK: nDCG@10=%.4f >= %.4f - %.3f",
                    got, expect, args.ndcg_tol)
    return ndcg


if __name__ == "__main__":
    main()
