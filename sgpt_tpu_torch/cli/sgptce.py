"""Cross-encoder reranking on the port (counterpart of `sgpt_tpu/cli/sgptce.py`).

Loads first-stage results, reranks each query's top-k with prompt-conditioned
log-prob scoring, and evaluates both:

    python -m sgpt_tpu_torch.cli.bm25_retriever --dataset scifact
    python -m sgpt_tpu_torch.cli.sgptce --dataset scifact --randominit \\
        --bm25results results_scifact.json --device cuda

The JAX CLI's flags, plus `--device` (one device, or a comma-separated
list that `--dp`/`--tp` arrange into a mesh, `cli/common.py`; `--tp`
shards GPT-J/BLOOM over the cards, the reference's device_map="auto").
Writes the same per-prompt result json
(`./sgptce_<dataset>_prompt<id>.json` unless `--output`) and the
cross-dataset `--scores-out` entries. `--quantize int8` quantizes the
decoder's projections in place after loading (`free_source=True`), then
the model is sharded (the JAX order).
`--modelpath` is a preset with `--randominit`
(GPT-Neo, GPT-J-6B, BLOOM-1b7) or a local HF checkpoint directory.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from ..ops.quant import quantize_decoder_params
from .common import (add_mesh_args, build_mesh, build_model, first_device, maybe_shard,
                     setup_logging)

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="scifact")
    p.add_argument("--modelpath", default="EleutherAI/gpt-neo-125M")
    p.add_argument("--datadir", default="./datasets")
    p.add_argument("--bm25results", required=False,
                   help="json of first-stage results {qid: {docid: score}}")
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--prompt", default="G",
                   help="prompt ablation id: A-I/quoraA-D (zero-shot), "
                        "J/K/quoraE (few-shot, needs --fewshot), L/M (Yes/No "
                        "classifier). The paper's main prompt is G. A comma "
                        "list (e.g. 'A,B,G,L') runs the whole ablation set in "
                        "one process on one loaded model")
    p.add_argument("--fewshot", action="store_true",
                   help="prepend the shortest relevant (doc, query) pair from "
                        "qrels as a one-shot example")
    p.add_argument("--min_corp_query_len", type=int, default=0,
                   help="few-shot selection: skip pairs shorter than this "
                        "many tokens (the Quora guard)")
    p.add_argument("--maxseqlen", type=int, default=None)
    p.add_argument("--randominit", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="int8 decoder projections (quantized in place after loading)")
    p.add_argument("--packt", type=int, default=None,
                   help="sequence packing: (doc, query) pairs shorter than "
                        "packt/2 tokens bin-pack several to a row with "
                        "block-diagonal attention (scores unchanged); 256 "
                        "suits short-document sets")
    p.add_argument("--output", default=None,
                   help="per-dataset result json; with a comma --prompt list "
                        "the prompt id is inserted before the extension")
    p.add_argument("--scores-out", default="./sgptce_ndcgs.json", dest="scores_out",
                   help="cross-dataset accumulation file ('' disables)")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on: cuda (the kernels; alone, every visible "
                   "card) or cpu (their plain versions), or a comma-separated list for "
                   "--dp/--tp")
    add_mesh_args(p)
    return p.parse_args(argv)


def main(args=None):
    setup_logging()
    args = args or parse_args()

    from ..ce_prompts import ALL_PROMPT_IDS, FEW_SHOT, build_ranker, select_fewshot
    from ..crossencoder import rerank
    from ..evaluation import EvaluateRetrieval, load_beir_dataset
    from ..evaluation.aggregate import ResultsStore

    # validate the whole --prompt list up front: a long ablation run must
    # not die halfway through on a typo'd or misconfigured id
    prompt_ids = [p.strip() for p in args.prompt.split(",") if p.strip()]
    for pid in prompt_ids:
        if pid not in ALL_PROMPT_IDS:
            raise SystemExit(f"unknown prompt id {pid!r}; choose from {ALL_PROMPT_IDS}")
        if pid in FEW_SHOT and not args.fewshot:
            raise SystemExit(f"prompt {pid!r} is few-shot — pass --fewshot")

    mesh = build_mesh(args)   # a bad --dp/--tp exits before anything is loaded
    device = first_device(args, mesh)
    data_path = os.path.join(args.datadir, args.dataset)
    split = "dev" if args.dataset == "msmarco" else "test"
    corpus, queries, qrels = load_beir_dataset(data_path, split)
    if not args.bm25results:
        raise SystemExit("--bm25results required (first-stage candidates json)")
    with open(args.bm25results) as f:
        first_stage = json.load(f)

    model, cfg, tokenizer = build_model(args.modelpath, random_init=args.randominit,
                                        dtype_str=args.dtype, device=device)
    if args.quantize:
        model = quantize_decoder_params(model, free_source=True)
    model = maybe_shard(model, mesh)
    fewshots = None
    if args.fewshot:
        fewshots = select_fewshot(corpus, queries, qrels, tokenizer,
                                  min_corp_query_len=args.min_corp_query_len)
        logger.info("few-shot example: doc=%r query=%r", fewshots[0][:80], fewshots[1][:80])

    k_values = (1, 3, 5, 10, 100)
    ndcg_bm25, *_ = EvaluateRetrieval.evaluate(qrels, first_stage, k_values)
    logger.info("BM25 nDCG: %s", ndcg_bm25)

    outputs = {}
    for prompt_id in prompt_ids:
        shots = fewshots if (args.fewshot or prompt_id in FEW_SHOT) else None
        ranker = build_ranker(prompt_id, model, cfg, tokenizer, fewshots=shots,
                              device=device, mesh=mesh, batch_size=args.batchsize,
                              max_length=args.maxseqlen, pack_t=args.packt)
        reranked = rerank(ranker, corpus, queries, first_stage, top_k=args.topk)
        ndcg_ce, _map, recall, precision = EvaluateRetrieval.evaluate(
            qrels, reranked, k_values)
        logger.info("SGPT-CE[%s] nDCG: %s", prompt_id, ndcg_ce)

        if args.scores_out:
            store = ResultsStore(path=args.scores_out)
            store.add(f"{args.modelpath.replace('/', '_')}_prompt{prompt_id}",
                      args.dataset.replace("/", "_"), ndcg_ce, _map, recall, precision)
            store.save()

        ds = args.dataset.replace("/", "_")  # cqadupstack/android etc.
        if args.output and len(prompt_ids) == 1:
            out = args.output
        elif args.output:  # comma list: keep the user's path, tag the prompt
            root, ext = os.path.splitext(args.output)
            out = f"{root}_prompt{prompt_id}{ext or '.json'}"
        else:
            out = f"./sgptce_{ds}_prompt{prompt_id}.json"
        with open(out, "w") as f:
            json.dump({"dataset": args.dataset, "model": args.modelpath,
                       "prompt": prompt_id, "fewshot": shots is not None,
                       "bm25_ndcg": ndcg_bm25, "ce_ndcg": ndcg_ce,
                       "ce_map": _map, "ce_recall": recall,
                       "ce_precision": precision}, f, indent=2)
        outputs[prompt_id] = out
    return outputs


if __name__ == "__main__":
    main()
