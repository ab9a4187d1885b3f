"""NLI contrastive training on the PyTorch port, symmetric search
(counterpart of `sgpt_tpu/cli/train_nli.py`).

The surface of the reference's training_nli_v2.py: AllNLI triplets (premise,
entailment, contradiction as the hard negative), NoDuplicates batches, MNRL,
BitFit (`--freezenonbias`), GradCache (`--gradcache --chunksize`), learnt
mean pooling (`--learntmean`), trainable dense heads (`--addxlinear N`,
`--linearthenpool`, `--useact`, `--outfeats`), and the STS-B dev evaluator
every 10 % of the epoch. The JAX CLI's flags, `--dp`/`--tp` included (a
mesh over the `--device` list; multi-device training is opt-in: `--dp`
defaults to 1), plus `--device`:

    python -m sgpt_tpu_torch.cli.train_nli --nli_path AllNLI.tsv.gz \\
        --stsb_path stsbenchmark.tsv.gz --model_name 125m --randominit \\
        --train_batch_size 64 --freezenonbias --lr 2e-4 --model_save_path output/nli

`--model_name` is a preset with `--randominit` (GPT-Neo by size, "6b" /
"5.8b" / "6.1b" for GPT-J-6B, "bloom" for BLOOM-1b7) or a local HF
checkpoint directory. Weights train in fp32 at matmul precision "default";
every tower pads to `--max_seq_length` (75), so each layer runs K1 forward
and K2 backward at T=75 on the card. Writes the last weights as a trainer
checkpoint to `--model_save_path` (as the JAX CLI), the best one by the
STS-B dev score to `<model_save_path>/best`, and the best model (the last
one without `--stsb_path`) as an `SGPTModel` to
`<model_save_path>/best_model`, which `SGPTModel.load` reads.
"""
from __future__ import annotations

import argparse
import logging
import os

from .common import add_mesh_args, build_mesh, build_model, first_device, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="EleutherAI/gpt-neo-125M")
    p.add_argument("--nli_path", required=True, help="AllNLI.tsv[.gz]")
    p.add_argument("--stsb_path", default=None, help="stsbenchmark dev tsv")
    p.add_argument("--train_batch_size", type=int, default=64)
    p.add_argument("--max_seq_length", type=int, default=75)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--scheduler", default="warmuplinear",
                   choices=["constantlr", "warmupconstant", "warmuplinear",
                            "warmupcosine", "warmupcosinewithhardrestarts"])
    p.add_argument("--pooling", default="weightedmean")
    p.add_argument("--learntmean", action="store_true",
                   help="trainable per-position pooling weights (ref :100-101)")
    p.add_argument("--addxlinear", type=int, default=0,
                   help="number of trainable linear heads (ref :46,:105-117)")
    p.add_argument("--linearthenpool", action="store_true",
                   help="apply linear heads before pooling (ref :48)")
    p.add_argument("--useact", action="store_true",
                   help="GELU activation on linear heads (ref :49)")
    p.add_argument("--outfeats", type=int, default=0,
                   help="output dim of the (single) linear head (ref :47)")
    p.add_argument("--freezenonbias", action="store_true")
    p.add_argument("--unfreezewte", action="store_true")
    p.add_argument("--gradcache", action="store_true")
    p.add_argument("--chunksize", type=int, default=8)
    p.add_argument("--model_save_path", default="output/nli")
    p.add_argument("--randominit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device(s) to train on: cuda (the kernels) or cpu "
                   "(their plain versions); a comma-separated list for a mesh")
    add_mesh_args(p)  # --dp/--tp: multi-device fit (replaces accelerate launch)
    p.set_defaults(dp=1)  # multi-device training is opt-in (--dp -1 = all)
    return p.parse_args(argv)


def dense_head_specs(args, hidden_size: int):
    """The trainer's `dense_heads` from the head flags (the JAX CLI's rules):
    `--addxlinear` heads of width `--outfeats` (else the hidden size), with
    no bias under BitFit (ref :107), GELU with `--useact`, before pooling
    with `--linearthenpool`; `--outfeats` takes exactly one head (`main`
    checks that before it builds the model)."""
    if not args.addxlinear:
        return None
    out_dim = args.outfeats or hidden_size
    return [{"in_features": hidden_size, "out_features": out_dim,
             "bias": not args.freezenonbias,
             "activation": "gelu" if args.useact else "identity",
             "location": "pre_pool" if args.linearthenpool else "post_pool"}
            for _ in range(args.addxlinear)]


def main(args=None):
    """Returns the trainer's `fit` result with the exported best model under
    "model" (an `SGPTModel` on the live decoder; under a mesh on an
    unsharded copy)."""
    setup_logging()
    args = args or parse_args()

    from ..data import NoDuplicatesBatcher, STSDataReader, build_nli_triplets, load_nli_tsv
    from ..evaluation.sts import EmbeddingSimilarityEvaluator
    from ..training import ContrastiveTrainer, TrainConfig

    if args.outfeats and args.addxlinear != 1:
        raise ValueError("--outfeats needs exactly one linear layer (ref :96)")
    mesh = build_mesh(args)  # before the data: a mesh the devices cannot make exits
    triplets = build_nli_triplets(load_nli_tsv(args.nli_path), seed=args.seed)
    logger.info("Built %d NLI triplets", len(triplets))
    batcher = NoDuplicatesBatcher(triplets, args.train_batch_size, seed=args.seed)

    model, cfg, tokenizer = build_model(args.model_name, random_init=args.randominit,
                                        dtype_str="float32", device=first_device(args, mesh),
                                        seed=args.seed)
    tc = TrainConfig(
        lr=args.lr, epochs=args.num_epochs, batch_size=args.train_batch_size,
        max_seq_len=args.max_seq_length, scheduler=args.scheduler,
        pooling="learned_weightedmean" if args.learntmean else args.pooling,
        freeze_nonbias=args.freezenonbias, train_wte=args.unfreezewte,
        use_gradcache=args.gradcache, chunk_size=args.chunksize,
        output_dir=args.model_save_path, seed=args.seed,
        dense_heads=dense_head_specs(args, cfg.hidden_size),
        eval_steps=max(1, len(batcher) // 10),  # eval every 10% (ref :188-202)
    )
    trainer = ContrastiveTrainer(model, cfg, tokenizer, tc, mesh=mesh)
    del model  # under a mesh the trainer holds its shards
    # the checkpoint's own tokenizer, which SGPTModel.load reads back (random
    # weights use the hash tokenizer, which the manifest records as such)
    tokenizer_name = None if args.randominit else args.model_name

    evaluator = None
    if args.stsb_path:
        # the dev split; the reader scales the scores to [0, 1], which leaves
        # the evaluator's rank and linear correlations as they were
        dev = STSDataReader(os.path.dirname(args.stsb_path)).get_examples(
            os.path.basename(args.stsb_path), split="dev")
        sts = EmbeddingSimilarityEvaluator([ex.texts[0] for ex in dev],
                                           [ex.texts[1] for ex in dev],
                                           [ex.label for ex in dev], name="sts-dev")

        def evaluator(model):
            # the live module with the trained heads and learnt weights
            return sts(trainer.export_model().encode)

    def batches():
        for batch in batcher:
            yield [ex.texts for ex in batch]

    out = trainer.fit(batches, steps_per_epoch=len(batcher), evaluator=evaluator)
    trainer.save_model(args.model_save_path)
    if trainer.best_params is not None:  # the best evaluation's weights
        trainer.load_weights(out["best_params"], out["best_aux"])
    out["model"] = trainer.export_model(tokenizer_name=tokenizer_name)
    out["model"].save(os.path.join(args.model_save_path, "best_model"))
    logger.info("done; best score %.4f", out["best_score"])
    return out


if __name__ == "__main__":
    main()
