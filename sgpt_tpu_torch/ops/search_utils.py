"""Embedding-space search utilities (counterpart of `sgpt_tpu/ops/search_utils.py`).

The sentence-transformers util surface: `semantic_search`,
`paraphrase_mining_embeddings` and `community_detection`, with the same
output shapes and the JAX functions' steps: normalise for cosine scores,
pad the corpus to a multiple of 128 rows (one host-to-device copy), top-k
through the block-max scan (`ops/topk.blockmax_topk`, as JAX runs them;
neither side uses the MIPS kernel here), one fetch per query chunk. They run
on `device`, the card by default; CPU use passes device="cpu".
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .pooling import normalize
from .similarity import cos_sim
from .topk import blockmax_topk


def _as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("search utilities: device 'cuda' requested but "
                           "torch.cuda.is_available() is False; pass device=\"cpu\"")
    return device


def semantic_search(query_embeddings, corpus_embeddings, *, top_k: int = 10,
                    score_function: str = "cos_sim", query_chunk_size: int = 1024,
                    device="cuda") -> List[List[Dict]]:
    """[[{'corpus_id': i, 'score': s}, ...] per query], best first."""
    dev = _device(device)
    q = torch.from_numpy(_as_np(query_embeddings))
    c = torch.from_numpy(_as_np(corpus_embeddings))
    if q.dim() == 1:
        q = q[None]
    if score_function == "cos_sim":
        q, c = normalize(q), normalize(c)
    elif score_function != "dot":
        raise ValueError(f"unknown score_function {score_function!r}; use 'cos_sim' or 'dot'")
    n = c.shape[0]
    n_pad = ((n + 127) // 128) * 128
    c_dev = torch.zeros((n_pad, c.shape[1]), dtype=c.dtype)
    c_dev[:n] = c
    c_dev = c_dev.to(dev)  # one host-to-device copy, not one a chunk
    out: List[List[Dict]] = []
    k = min(top_k, n)
    for s in range(0, len(q), query_chunk_size):
        vals, idx = blockmax_topk(q[s: s + query_chunk_size].to(dev), c_dev, n, k=k)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()  # one fetch a chunk
        for vrow, irow in zip(vals, idx):
            out.append([{"corpus_id": int(i), "score": float(v)} for v, i in zip(vrow, irow)])
    return out


def paraphrase_mining_embeddings(embeddings, *, top_k: int = 100, max_pairs: int = 500000,
                                 device="cuda") -> List[List]:
    """[[score, id1, id2], ...] best first, self and duplicate pairs removed."""
    emb = _as_np(embeddings)
    hits = semantic_search(emb, emb, top_k=min(top_k + 1, len(emb)), device=device)
    pairs = {}
    for i, row in enumerate(hits):
        for h in row:
            j = h["corpus_id"]
            if i == j:
                continue
            key = (min(i, j), max(i, j))
            if key not in pairs or h["score"] > pairs[key]:
                pairs[key] = h["score"]
    ranked = sorted(pairs.items(), key=lambda kv: -kv[1])[:max_pairs]
    return [[score, a, b] for (a, b), score in ranked]


def community_detection(embeddings, *, threshold: float = 0.75, min_community_size: int = 10,
                        init_max_size: int = 1000, device="cuda") -> List[List[int]]:
    """Fast community detection: greedy clusters of mutually close
    embeddings, largest first, the community's central point first."""
    dev = _device(device)
    emb = _as_np(embeddings)
    n = len(emb)
    e = torch.from_numpy(emb).to(dev)
    scores = cos_sim(e, e).cpu().numpy()

    k = min(min_community_size, n)
    kth = np.sort(scores, axis=1)[:, -k]
    candidates = np.where(kth >= threshold)[0]

    extracted = []
    for i in candidates:
        members = np.where(scores[i] >= threshold)[0]
        order = np.argsort(-scores[i][members])
        extracted.append([int(m) for m in members[order]][:max(init_max_size, k)])

    extracted.sort(key=len, reverse=True)
    unique: List[List[int]] = []
    seen: set = set()
    for comm in extracted:
        if any(idx in seen for idx in comm):
            continue
        unique.append(comm)
        seen.update(comm)
    return [c for c in unique if len(c) >= min_community_size]
