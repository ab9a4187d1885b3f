"""MS MARCO contrastive training on the PyTorch port (counterpart of
`sgpt_tpu/cli/train_msmarco.py`).

Same flags as the JAX CLI, `--dp`/`--tp` included (a mesh over the
`--device` list, e.g. `--device cuda:0,cuda:1 --dp 2`; multi-device training
is opt-in: `--dp` defaults to 1), plus `--device`. Hard negatives with CE-score
margin filtering, SPECB brackets (`--specb`), BitFit (`--freezenonbias`),
per-epoch checkpoints, optional MS MARCO dev IR eval. Expects the
reference's data files in `--data_folder`: collection.tsv (pid\\ttext),
queries.tsv (qid\\ttext), hard-negatives.jsonl ({qid, pos: [pid], neg:
{system: [pid]}}) and optionally ce-scores.json ({qid: {pid: score}}).

    python -m sgpt_tpu_torch.cli.train_msmarco --data_folder data/msmarco \\
        --randominit --train_batch_size 32 --specb --freezenonbias --lr 2e-4

`--model_name` is a preset with `--randominit` (GPT-Neo by size, "6b" /
"5.8b" / "6.1b" for GPT-J-6B, "bloom" for BLOOM-1b7) or a local HF
checkpoint directory of any of the three families (`models/hf_loader.py`).
Weights train in fp32 at matmul precision "default". The paper's SGPT-5.8B
run is BitFit with GradCache at chunk size 4:

    python -m sgpt_tpu_torch.cli.train_msmarco --data_folder data/msmarco \
        --model_name 6b --randominit --train_batch_size 32 --specb \
        --freezenonbias --gradcache --chunksize 4 --lr 2e-4

GPT-J's head size 256 takes K1's `tf32_kernel_wide` and K2's
`tf32_rows_wide`/`tf32_cols_wide` (3xTF32 on the tensor cores) at T=300,
and K3 and K4a/K4b (`flash_bwd_dq_wide`, `flash_bwd_dkv_wide`) with a
`use_flash` config; BLOOM's ALiBi slopes reach every kernel.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os

from .common import add_mesh_args, build_mesh, build_model, first_device, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="EleutherAI/gpt-neo-125M")
    p.add_argument("--data_folder", required=True)
    p.add_argument("--train_batch_size", type=int, default=64)
    p.add_argument("--max_seq_length", type=int, default=300)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--scheduler", default="warmuplinear",
                   choices=["constantlr", "warmupconstant", "warmuplinear",
                            "warmupcosine", "warmupcosinewithhardrestarts"])
    p.add_argument("--pooling", default="weightedmean")
    p.add_argument("--specb", action="store_true")
    p.add_argument("--freezenonbias", action="store_true")
    p.add_argument("--unfreezewte", action="store_true")
    p.add_argument("--gradcache", action="store_true")
    p.add_argument("--chunksize", type=int, default=8)
    p.add_argument("--ce_score_margin", type=float, default=3.0)
    p.add_argument("--num_negs_per_system", type=int, default=5)
    p.add_argument("--model_save_path", default="output/msmarco")
    p.add_argument("--randominit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device(s) to train on: cuda (the kernels) or cpu "
                   "(their plain versions); a comma-separated list for a mesh")
    add_mesh_args(p)  # --dp/--tp: multi-device fit (replaces accelerate launch)
    p.set_defaults(dp=1)  # multi-device training is opt-in (--dp -1 = all)
    # final dev-set IR eval (train_bi-encoder_mnrl.py:520-527): expects
    # dev-queries.tsv + dev-qrels.tsv (qid\tpid) in data_folder
    p.add_argument("--eval_dev", action="store_true")
    p.add_argument("--dev_corpus_sample", type=int, default=10000)
    return p.parse_args(argv)


def _open(path):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def load_msmarco(folder: str, ce_margin: float, negs_per_system: int):
    from ..data.msmarco import filter_hard_negatives

    corpus = {}
    with _open(os.path.join(folder, "collection.tsv")) as f:
        for line in f:
            pid, text = line.rstrip("\n").split("\t", 1)
            corpus[pid] = text
    queries = {}
    with _open(os.path.join(folder, "queries.tsv")) as f:
        for line in f:
            qid, text = line.rstrip("\n").split("\t", 1)
            queries[qid] = text

    ce_path = os.path.join(folder, "ce-scores.json")
    ce_scores = json.load(_open(ce_path)) if os.path.exists(ce_path) else {}

    qrels = {}
    with _open(os.path.join(folder, "hard-negatives.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            qid, pos = str(row["qid"]), [str(p) for p in row["pos"]]
            if not pos:
                continue
            neg_ids = []
            for system_negs in row.get("neg", {}).values():
                sys_negs = [str(p) for p in system_negs]
                if ce_scores.get(qid):
                    kept = filter_hard_negatives(
                        [(p, ce_scores[qid].get(p, -1e9)) for p in sys_negs],
                        [ce_scores[qid].get(p, 0.0) for p in pos],
                        ce_margin=ce_margin, max_negs=negs_per_system)
                else:
                    kept = sys_negs[:negs_per_system]
                neg_ids.extend(kept)
            if neg_ids:
                qrels[qid] = {"pos": pos, "neg": list(dict.fromkeys(neg_ids))}
    return corpus, queries, qrels


def main(args=None):
    setup_logging()
    args = args or parse_args()

    from ..data import MSMARCOTriplets

    from ..training import ContrastiveTrainer, TrainConfig

    mesh = build_mesh(args)  # before the data: a mesh the devices cannot make exits
    corpus, queries, qrels = load_msmarco(args.data_folder, args.ce_score_margin,
                                          args.num_negs_per_system)
    logger.info("%d train queries with hard negatives", len(qrels))
    dataset = MSMARCOTriplets(queries, corpus, qrels, seed=args.seed)

    device = first_device(args, mesh)
    model, cfg, tokenizer = build_model(args.model_name, random_init=args.randominit,
                                        dtype_str="float32", device=device, seed=args.seed)
    tc = TrainConfig(
        lr=args.lr, epochs=args.epochs, batch_size=args.train_batch_size,
        max_seq_len=args.max_seq_length, scheduler=args.scheduler,
        pooling=args.pooling, specb=args.specb,
        freeze_nonbias=args.freezenonbias, train_wte=args.unfreezewte,
        use_gradcache=args.gradcache, chunk_size=args.chunksize,
        output_dir=args.model_save_path, seed=args.seed,
        checkpoint_steps=max(1, len(dataset) // args.train_batch_size),  # per epoch
    )
    trainer = ContrastiveTrainer(model, cfg, tokenizer, tc, mesh=mesh)
    del model  # under a mesh the trainer holds its shards

    B = args.train_batch_size

    def batches():
        epoch = dataset.epoch()
        for s in range(0, len(epoch) - B + 1, B):
            yield [ex.texts for ex in epoch[s: s + B]]

    steps = max(1, len(dataset) // B)
    out = trainer.fit(batches, steps_per_epoch=steps)
    trainer.save_model(args.model_save_path)
    logger.info("done; final loss %.4f", out["history"][-1].get("loss", -1))

    if args.eval_dev:
        import random

        from ..evaluation.ir import InformationRetrievalEvaluator

        from ..encoder import EmbeddingEngine

        dev_queries, dev_rel = {}, {}
        with _open(os.path.join(args.data_folder, "dev-queries.tsv")) as f:
            for line in f:
                qid, text = line.rstrip("\n").split("\t", 1)
                dev_queries[qid] = text
        with _open(os.path.join(args.data_folder, "dev-qrels.tsv")) as f:
            for line in f:
                qid, pid = line.rstrip("\n").split("\t")[:2]
                dev_rel.setdefault(qid, set()).add(pid)
        needed = {p for s in dev_rel.values() for p in s}
        pool_ids = list(needed)
        rng = random.Random(args.seed)
        extra = [p for p in corpus if p not in needed]
        pool_ids += rng.sample(extra, min(args.dev_corpus_sample, len(extra)))
        dev_corpus = {p: corpus[p] for p in pool_ids if p in corpus}

        engine = EmbeddingEngine(trainer.model, cfg, tokenizer, device=device,
                                 mesh=trainer.mesh, method=args.pooling, specb=args.specb,
                                 max_seq_len=args.max_seq_length)
        ev = InformationRetrievalEvaluator(dev_queries, dev_corpus, dev_rel,
                                           main_metric="mrr@10", name="ms-dev")
        score = ev(lambda texts: engine.encode(texts, is_query=True),
                   lambda texts: engine.encode(texts))
        logger.info("MSMARCO dev MRR@10: %.4f", score)
    return out


if __name__ == "__main__":
    main()
