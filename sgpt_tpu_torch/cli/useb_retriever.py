"""USEB bi-encoder evaluation on the PyTorch port (counterpart of
`sgpt_tpu/cli/useb_retriever.py`).

The surface of the reference's useb_dense_retriever.py: the four USEB tasks
(AskUbuntu, CQADupStack, TwitterPara, SciDocs) from `--datapath`, with the
pooling method (every pooler of the engine that needs no trained weights,
the all-layer `meanmean` and `lasttokenmean` included) and the layer
(`--layeridx`: 0 the embeddings, -1 the final states) to sweep:

    python -m sgpt_tpu_torch.cli.useb_retriever --datapath data-eval \\
        --modelname 125m --randominit --method weightedmean --layeridx 6

The JAX CLI's flags plus `--device`. Writes the same JSON to `--output`:
{"detailed", "main", "model", "method", "layeridx"}. `--quantize` (int8,
ROADMAP Queue 1 item 9) raises, and so does `--download`: the port copies
no download helper for USEB and fetches nothing.
"""
from __future__ import annotations

import argparse
import json
import logging

from .common import build_model, setup_logging

logger = logging.getLogger(__name__)

METHODS = ["mean", "weightedmean", "lasttoken", "max", "cls", "meanmean", "lasttokenmean"]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--modelname", default="EleutherAI/gpt-neo-125M")
    p.add_argument("--method", default="weightedmean", choices=METHODS)
    p.add_argument("--layeridx", type=int, default=-1)
    p.add_argument("--batchsize", type=int, default=32)
    p.add_argument("--maxseqlen", type=int, default=None)
    p.add_argument("--specb", action="store_true")
    p.add_argument("--datapath", default="./data-eval")
    p.add_argument("--download", action="store_true",
                   help="fetch the USEB archive (not ported: raises; point --datapath at a "
                        "local copy)")
    p.add_argument("--evaltype", default="test", choices=["valid", "test"])
    p.add_argument("--tasks", nargs="+",
                   default=["askubuntu", "cqadupstack", "twitterpara", "scidocs"])
    p.add_argument("--randominit", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="int8 decoder projections (not ported yet: ROADMAP Queue 1 item 9)")
    p.add_argument("--output", default="./useb_results.json")
    p.add_argument("--device", default="cuda",
                   help="torch device to encode on: cuda (the kernels) or cpu (their plain "
                   "versions)")
    return p.parse_args(argv)


def main(args=None):
    """Returns (detailed results, main scores)."""
    setup_logging()
    args = args or parse_args()
    if args.quantize:
        raise NotImplementedError("--quantize: int8 inference is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    if args.download:
        raise NotImplementedError("--download: the port fetches no USEB data; point "
                                  "--datapath at a local copy of data-eval")

    from ..encoder import EmbeddingEngine
    from ..evaluation.useb import run

    model, cfg, tokenizer = build_model(args.modelname, random_init=args.randominit,
                                        dtype_str=args.dtype, device=args.device)
    engine = EmbeddingEngine(model, cfg, tokenizer, device=args.device, method=args.method,
                             specb=args.specb, layeridx=args.layeridx,
                             max_seq_len=args.maxseqlen, batch_size=args.batchsize)
    semb_fns = {task: engine.encode for task in args.tasks}
    results, mains = run(semb_fns, eval_type=args.evaltype, data_eval_path=args.datapath)
    logger.info("USEB main scores: %s", mains)
    with open(args.output, "w") as f:
        json.dump({"detailed": results, "main": mains, "model": args.modelname,
                   "method": args.method, "layeridx": args.layeridx}, f, indent=2)
    return results, mains


if __name__ == "__main__":
    main()
