"""Serve embeddings and semantic search over HTTP from one process
(counterpart of `sgpt_tpu/cli/serve.py`).

    python -m sgpt_tpu_torch.cli.serve --modelname gpt-neo-125m --randominit \\
        --device cuda --port 8080 --corpus corpus.jsonl --quantize-index int8 \\
        [--index ivf --clusters auto --nprobe 32] [--quantize int8]
    python -m sgpt_tpu_torch.cli.serve --modelname gpt-neo-125m --randominit \\
        --device cuda:0,cuda:1 --dp 2 --corpus corpus.jsonl --rerank

The JAX CLI's flags, plus `--device`: one device, or a comma-separated list
that `--dp`/`--tp` arrange into a mesh (`cli/common.py`), which the engine,
the index (its corpus sharded over dp), the ranker and `--index-path`'s
load all run on. `--modelname` is a preset with `--randominit` (GPT-Neo,
GPT-J-6B, BLOOM-1b7) or a local HF checkpoint directory. `--index exact`
searches with the block-max scan, `--index ivf` with the balanced IVF index
(`index_ivf.IVFIndex`: `--clusters`, `--nprobe`); `--quantize-index int8`
stores the corpus in int8, `--quantize int8` runs the encoder's (and the
ranker's) decoder projections in int8. `--rerank` enables POST /rerank: the
SGPT-CE ranker (`ce_prompts.build_ranker`) on the encoder's model, or with
`--rerank-model` on a second model.

corpus.jsonl rows: {"_id": ..., "title": ..., "text": ...} (BEIR shape) or
{"id": ..., "text": ...}; omit --corpus to start empty and POST /documents.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from .common import add_mesh_args, build_mesh, build_model, first_device, setup_logging

logger = logging.getLogger(__name__)


def load_jsonl_corpus(path: str):
    """(ids, texts) from a BEIR-shaped jsonl file, title and text joined as
    the BEIR scripts join them (the JAX `load_jsonl_corpus`)."""
    from ..data.jsonl_native import extract_fields

    ids, texts = [], []
    rows = extract_fields(path, ("_id", "id", "title", "text"))
    if rows is not None:  # native one-pass extraction
        for _id, id_, title, text in rows:
            doc_id = _id if _id is not None else id_
            ids.append(str(doc_id) if doc_id is not None else str(len(ids)))
            title, text = title or "", text or ""
            texts.append((title + " " + text).strip() if title else text)
        return ids, texts
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            doc_id = str(row.get("_id", row.get("id", len(ids))))
            title = row.get("title", "")
            text = row.get("text", "")
            ids.append(doc_id)
            texts.append((title + " " + text).strip() if title else text)
    return ids, texts


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--modelname", required=True)
    ap.add_argument("--randominit", action="store_true",
                    help="random weights (zero-egress smoke serving)")
    ap.add_argument("--method", default="weightedmean")
    ap.add_argument("--specb", action="store_true")
    ap.add_argument("--maxseqlen", type=int, default=300)
    ap.add_argument("--batchsize", type=int, default=64)
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8 decoder projections for the encoder and the ranker")
    ap.add_argument("--quantize-index", choices=["int8"], default=None,
                    help="int8 corpus storage")
    ap.add_argument("--index", choices=["exact", "ivf"], default="exact",
                    help="exact scan, or balanced-IVF ANN")
    ap.add_argument("--clusters", default="auto",
                    type=lambda s: s if s == "auto" else int(s),
                    help="IVF cluster count, or 'auto' (with --index ivf)")
    ap.add_argument("--nprobe", type=int, default=32,
                    help="IVF clusters probed per query (with --index ivf)")
    ap.add_argument("--corpus", default=None, help="jsonl corpus to index at start")
    ap.add_argument("--index-path", default=None,
                    help="persisted-index directory: loaded at startup if it "
                    "exists (skips the corpus re-encode), target of POST "
                    "/save, and auto-saved after an initial --corpus build")
    ap.add_argument("--allow-save-path", action="store_true",
                    help="let POST /save clients pass {\"path\": ...} (writes "
                    "server-side files wherever the client says; off by "
                    "default — /save targets --index-path)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-wait-ms", type=float, default=3.0,
                    help="micro-batcher coalescing window")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip running the encode buckets and search shapes "
                    "once at startup (the first requests then build the kernels)")
    ap.add_argument("--rerank", action="store_true",
                    help="enable POST /rerank (SGPT-CE log-prob reranking) with the "
                    "encoder's model: no second copy of the weights")
    ap.add_argument("--rerank-model", default=None,
                    help="separate causal-LM checkpoint for /rerank (loads a second "
                    "model onto the device)")
    ap.add_argument("--rerank-maxlen", type=int, default=2048,
                    help="max context tokens per (query, doc) rerank pair")
    ap.add_argument("--rerank-prompt", default="G",
                    help="CE prompt ablation id (ce_prompts registry)")
    ap.add_argument("--rerank-pack-t", type=int, default=None,
                    help="CE sequence packing length")
    ap.add_argument("--device", default="cuda",
                    help="torch device to encode and search on: cuda (the kernels; alone, "
                    "every visible card) or cpu (their plain versions), or a "
                    "comma-separated list for --dp/--tp")
    add_mesh_args(ap)
    return ap.parse_args(argv)


def build_server(args):
    """(server, service) from parsed flags: the model and engine on
    --device (or the --dp/--tp mesh), the ranker with --rerank or
    --rerank-model, the index (loaded from --index-path, or an empty --index
    one filled from --corpus), encode and search warmed unless --no-warmup;
    the caller runs serve_forever()."""
    from ..encoder import EmbeddingEngine
    from ..index import DenseIndex
    from ..index_ivf import IVFIndex
    from ..serving import SearchService, make_server

    mesh = build_mesh(args)
    device = first_device(args, mesh)
    model, cfg, tokenizer = build_model(args.modelname, random_init=args.randominit,
                                        dtype_str="bfloat16", device=device)
    # the engine makes the int8 copy (--quantize) and shards it over the mesh
    engine = EmbeddingEngine(
        model, cfg, tokenizer, device=device, mesh=mesh, method=args.method,
        specb=args.specb, max_seq_len=args.maxseqlen, batch_size=args.batchsize,
        normalize_embeddings=True, quantize=args.quantize)
    ranker = None
    if args.rerank or args.rerank_model:
        from ..ce_prompts import build_ranker
        ce_quantize = None
        if args.rerank_model:
            ce_model, ce_cfg, ce_tok = build_model(args.rerank_model,
                                                   random_init=args.randominit,
                                                   dtype_str="bfloat16", device=device)
            ce_quantize = args.quantize
        else:  # the encoder's (int8 with --quantize, sharded on a mesh) model: no
            # second copy of the weights
            ce_model, ce_cfg, ce_tok = engine.model, cfg, tokenizer
        ranker = build_ranker(args.rerank_prompt, ce_model, ce_cfg, ce_tok,
                              device=device, mesh=mesh, batch_size=args.batchsize,
                              max_length=args.rerank_maxlen, pack_t=args.rerank_pack_t,
                              quantize=ce_quantize)

    loaded = False
    if args.index_path and os.path.exists(os.path.join(args.index_path, "index.npz")):
        index, documents = SearchService.load_index(args.index_path, mesh=mesh,
                                                    device=engine.device)
        if index.dim != engine.out_dim:
            raise SystemExit(f"--index-path holds dim={index.dim} embeddings "
                             f"but the model produces {engine.out_dim}")
        logger.info("loaded %d docs from %s", len(index), args.index_path)
        service = SearchService(engine, index, documents=documents,
                                max_wait_ms=args.max_wait_ms, ranker=ranker)
        loaded = True
    else:
        if args.index == "ivf":
            index = IVFIndex(engine.out_dim, n_clusters=args.clusters, nprobe=args.nprobe,
                             normalize_embeddings=True, quantize=args.quantize_index,
                             device=engine.device, mesh=mesh)
        else:
            index = DenseIndex(engine.out_dim, normalize_embeddings=True,
                               quantize=args.quantize_index, device=engine.device, mesh=mesh)
        service = SearchService(engine, index, max_wait_ms=args.max_wait_ms, ranker=ranker)

    if args.corpus and not loaded:
        ids, texts = load_jsonl_corpus(args.corpus)
        logger.info("indexing %d docs from %s ...", len(texts), args.corpus)
        service.add_documents(texts, ids=ids, build=True)
        if args.index_path:
            logger.info("saving index to %s", args.index_path)
            service.save(args.index_path)

    if not args.no_warmup:
        logger.info("warming encode buckets and search shapes ...")
        engine.warmup()
        service.warm_search()

    server = make_server(service, args.host, args.port, model_name=args.modelname,
                         index_path=args.index_path, allow_save_path=args.allow_save_path)
    return server, service


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    server, service = build_server(args)
    logger.info("serving %s on http://%s:%d (docs=%d)", args.modelname,
                *server.server_address[:2], len(service.index))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
