"""TSDAE unsupervised pretraining on the PyTorch port (counterpart of
`sgpt_tpu/cli/train_tsdae.py`).

The sentence-transformers TSDAE recipe (DenoisingAutoEncoderLoss with a tied
encoder and decoder, DenoisingAutoEncoderDataset's deletion noise): read a
plain sentence file, train the model to reconstruct each original from its
noisy encoding, keep the encoder as the sentence embedder. The JAX CLI's
flags, plus `--device`:

    python -m sgpt_tpu_torch.cli.train_tsdae --sentences_path sentences.txt \\
        --model_name 125m --randominit --train_batch_size 8 \\
        --model_save_path output/tsdae

`--model_name` is a preset with `--randominit` (GPT-Neo by size, "6b" /
"5.8b" / "6.1b" for GPT-J-6B, "bloom" for BLOOM-1b7) or a local HF
checkpoint directory. Weights train in fp32 at matmul precision "default";
every sentence pads to `--max_seq_length` (75), so on the card each layer
runs K1 and K2 at T=75 (encoder) and T=74 (decoder). Writes the trainer's
`tree` ({"model", "tsdae"}) with `training.checkpoint.save_checkpoint` to
`--model_save_path`.
"""
from __future__ import annotations

import argparse
import logging

from .common import build_model, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_name", default="EleutherAI/gpt-neo-125M")
    p.add_argument("--sentences_path", required=True,
                   help="text file, one sentence per line")
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--max_seq_length", type=int, default=75)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--del_ratio", type=float, default=0.6)
    p.add_argument("--pooling", default="weightedmean")
    p.add_argument("--freezenonbias", action="store_true")
    p.add_argument("--model_save_path", default="output/tsdae")
    p.add_argument("--randominit", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on: cuda (the kernels) or cpu "
                   "(their plain versions)")
    return p.parse_args(argv)


def main(args=None, log_fn=None) -> dict:
    """Runs the CLI; returns {"history", "trainer"}. log_fn, if given, is
    called with each step's record after the log line."""
    setup_logging()
    args = args or parse_args()

    from ..data import DenoisingBatcher
    from ..training import TSDAETrainer
    from ..training.checkpoint import save_checkpoint

    model, cfg, tokenizer = build_model(args.model_name, random_init=args.randominit,
                                        dtype_str="float32", device=args.device,
                                        seed=args.seed)

    with open(args.sentences_path) as f:
        sentences = [ln.strip() for ln in f if ln.strip()]
    if len(sentences) < args.train_batch_size:
        raise SystemExit(f"need at least --train_batch_size={args.train_batch_size} "
                         f"sentences, got {len(sentences)} in {args.sentences_path}")
    logger.info("%d sentences", len(sentences))

    batcher = DenoisingBatcher(sentences, args.train_batch_size, del_ratio=args.del_ratio,
                               seed=args.seed)
    trainer = TSDAETrainer(model, cfg, tokenizer, pooling=args.pooling,
                           max_seq_len=args.max_seq_length, lr=args.lr,
                           freeze_nonbias=args.freezenonbias, seed=args.seed)

    def log_step(record):
        logger.info("step %d loss %.4f", record["step"], record["loss"])
        if log_fn:
            log_fn(record)

    history = trainer.fit(batcher, epochs=args.num_epochs, log_fn=log_step)
    save_checkpoint(args.model_save_path, trainer.tree, step=None)
    logger.info("done; %d steps, final loss %.4f", len(history),
                history[-1]["loss"] if history else float("nan"))
    return {"history": history, "trainer": trainer}


if __name__ == "__main__":
    main()
