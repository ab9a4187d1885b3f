"""USEB — Unsupervised Sentence Embedding Benchmark harness (4 tasks).

The port's own copy of `sgpt_tpu/evaluation/useb.py`, with the same behaviour: the
port imports nothing of the JAX package.

Clean-room, vectorized re-implementation of the forked USEB benchmark the
reference ships (biencoder/useb/useb/useb/): same on-disk data formats, metric
names, and score conventions (×100, 2 decimals) so results are directly
comparable, but embeddings are computed in large batches per dataset instead of
per-query mini-batches.

Tasks and metrics (SURVEY.md §2a):
  askubuntu   — rerank BM25 top-20 by cosine; MAP / P@1 / P@5 / MRR
                (evaluators/askubuntu.py:96-109; note its AP = mean of P@k at
                relevant ranks over the *retrieved* list)
  cqadupstack — full retrieval per forum; MAP@100 (sklearn AP over top-100) and
                nDCG@10 with ideal = all-relevant prefix; 12-forum average
                (evaluators/cqadupstack.py:75-88)
  twitterpara — paraphrase scoring; AP over binary labels + Spearman vs graded
                scores, averaged over TwitterURL and PIT (evaluators/twitterpara.py:70-88)
  scidocs     — cite/cocite/coview/coread; untruncated MAP and nDCG under both
                cosine and euclidean, averaged (evaluators/scidocs.py:32-47)

`semb_fn` is any `list[str] -> (N, D) array` callable (e.g.
EmbeddingEngine.encode); embeddings are L2-normalized here when normalize=True,
matching BaseEvaluator._text2se (evaluators/base.py:26-37).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .metrics import spearman

logger = logging.getLogger(__name__)

SembFn = Callable[[List[str]], np.ndarray]


def _embed(semb_fn: SembFn, texts: Sequence[str], normalize: bool) -> np.ndarray:
    emb = np.asarray(semb_fn([t.strip() for t in texts]), np.float32)
    if normalize:
        emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12, None)
    return emb


def _round(results: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v * 100, 2) for k, v in results.items()}


def _sklearn_ap(labels: Sequence[int], scores: Sequence[float]) -> float:
    """average_precision_score for binary labels (computed directly: AP =
    sum over relevant ranks of P@rank / n_relevant, scores sorted desc)."""
    order = np.argsort(-np.asarray(scores), kind="stable")
    y = np.asarray(labels)[order]
    n_rel = int(y.sum())
    if n_rel == 0:
        return 0.0
    hits = np.cumsum(y)
    prec = hits / np.arange(1, len(y) + 1)
    return float((prec * y).sum() / n_rel)


# ---------------------------------------------------------------------------
# AskUbuntu
# ---------------------------------------------------------------------------

def _askubuntu_ap(gold: set, ranked: List[str]) -> Dict[str, float]:
    """USEB's AP variant: mean of P@k at each relevant rank in the retrieved
    list (NOT divided by total gold size) — askubuntu.py:75-95."""
    ap, p1, p5 = [], 0.0, 0.0
    hits = 0
    for i, qid in enumerate(ranked):
        k = i + 1
        if qid in gold:
            hits += 1
        p_at_k = hits / k
        if k == 1:
            p1 = p_at_k
        if k == 5:
            p5 = p_at_k
        if qid in gold:
            ap.append(p_at_k)
    rr = 0.0
    for i, qid in enumerate(ranked):
        if qid in gold:
            rr = 1.0 / (i + 1)
            break
    return {"map": float(np.mean(ap)) if ap else 0.0, "p@1": p1, "p@5": p5, "mrr": rr}


class AskubuntuEvaluator:
    name = "askubuntu"
    main_metric = "map_askubuntu_title"

    def __init__(self, semb_fn: SembFn, datasets_dir: str,
                 text_components: str = "title"):
        self.semb_fn = semb_fn
        self.text_components = text_components
        self.pool: Dict[str, Dict[str, str]] = {}
        with open(os.path.join(datasets_dir, "text_tokenized.txt")) as f:
            for line in f:
                qid, title, body = line.split("\t")
                self.pool[qid.strip()] = {"title": title.strip(), "body": body.strip()}
        self.splits = {}
        for split, fname in (("valid", "dev.txt"), ("test", "test.txt")):
            rows = []
            with open(os.path.join(datasets_dir, fname)) as f:
                for line in f:
                    qid, gold, cands, scores = line.split("\t")
                    cands = cands.split()
                    scores = list(map(float, scores.strip().split()))
                    order = np.argsort(-np.asarray(scores), kind="stable")
                    bm25_rank = [cands[i] for i in order]
                    rows.append((qid, gold.split(), bm25_rank))
            self.splits[split] = rows

    def _text(self, qid: str) -> str:
        e = self.pool[qid]
        if self.text_components == "title_and_body":
            return e["title"] + " " + e["body"]
        return e[self.text_components]

    def run(self, eval_type: str = "test", normalize: bool = True) -> Dict[str, float]:
        rows = [r for r in self.splits[eval_type] if r[1]]
        # one big embedding pass over every unique qid involved
        qids = sorted({q for row in rows for q in [row[0], *row[2]]})
        emb = _embed(self.semb_fn, [self._text(q) for q in qids], normalize)
        index = {q: i for i, q in enumerate(qids)}

        agg: Dict[str, List[float]] = {}
        for qid, gold, bm25_rank in rows:
            scores = emb[index[qid]] @ emb[[index[c] for c in bm25_rank]].T
            order = np.argsort(-scores, kind="stable")
            ranked = [bm25_rank[i] for i in order]
            res = _askubuntu_ap(set(gold), ranked)
            for k, v in res.items():
                agg.setdefault(k, []).append(v)
        suffix = f"askubuntu_{self.text_components}"
        return _round({f"{k}_{suffix}": float(np.mean(v)) for k, v in agg.items()})


# ---------------------------------------------------------------------------
# CQADupStack
# ---------------------------------------------------------------------------

class CQADupStackEvaluator:
    name = "cqadupstack"
    main_metric = "map@100_cqadupstack_avg"

    def __init__(self, semb_fn: SembFn, datasets_dir: str, forum: str = "all"):
        self.semb_fn = semb_fn
        with open(os.path.join(datasets_dir, "corpus.json")) as f:
            self.corpus = json.load(f)
        with open(os.path.join(datasets_dir, "retrieval_split.json")) as f:
            self.split = json.load(f)
        self.forums = list(self.corpus) if forum == "all" else [forum]

    def run(self, eval_type: str = "test", normalize: bool = True) -> Dict[str, float]:
        results: Dict[str, float] = {}
        for forum in self.forums:
            qrels = self.split[eval_type][forum]
            pool = {d: t for d, t in self.corpus[forum].items() if d not in qrels}
            dids = list(pool)
            qids = list(qrels)
            q_emb = _embed(self.semb_fn, [self.corpus[forum][q] for q in qids], normalize)
            d_emb = _embed(self.semb_fn, [pool[d] for d in dids], normalize)
            scores = q_emb @ d_emb.T

            aps, ndcgs = [], []
            k_top = min(100, scores.shape[1])
            top100 = np.argpartition(-scores, k_top - 1, axis=1)[:, :k_top]
            for i, qid in enumerate(qids):
                rel = set(qrels[qid])
                idx = top100[i][np.argsort(-scores[i, top100[i]], kind="stable")]
                labels = [1 if dids[j] in rel else 0 for j in idx]
                aps.append(_sklearn_ap(labels, scores[i, idx].tolist())
                           if 1 in labels else 0.0)
                # ndcg@10: gains from ranking, ideal = all-relevant prefix
                gains = labels[:10]
                dcg = sum(g / np.log2(r + 2) for r, g in enumerate(gains))
                ideal = sum(1 / np.log2(r + 2) for r in range(min(len(rel), 10)))
                if ideal > 0:
                    ndcgs.append(dcg / ideal)
            results[f"map@100_cqadupstack_{forum}"] = float(np.mean(aps))
            results[f"ndcg@10_cqadupstack_{forum}"] = float(np.mean(ndcgs))
        if len(self.forums) > 1:
            results["map@100_cqadupstack_avg"] = float(np.mean(
                [v for k, v in results.items() if k.startswith("map@100_cqadupstack_")]))
            results["ndcg@10_cqadupstack_avg"] = float(np.mean(
                [v for k, v in results.items() if k.startswith("ndcg@10_cqadupstack_")]))
        return _round(results)


# ---------------------------------------------------------------------------
# TwitterPara
# ---------------------------------------------------------------------------

def _parse_twitter_rows(path: str, fmt: str):
    rows = []
    with open(path) as f:
        for line in f:
            items = line.strip().split("\t")
            if fmt == "url":
                s1, s2, label_s = items[0], items[1], items[2]
                label = int(label_s.strip("()").split(",")[0])
            else:  # PIT test.data
                s1, s2, label = items[2], items[3], int(items[4])
            score = label * 20
            is_para = None if label == 3 else (1 if label > 3 else 0)
            rows.append((s1, s2, is_para, score))
    return rows


class TwitterParaEvaluator:
    name = "twitterpara"
    main_metric = "ap_twitter_avg"

    def __init__(self, semb_fn: SembFn, datasets_dir: str, dname: str = "all"):
        self.semb_fn = semb_fn
        self.datasets = {}
        if dname in ("all", "twitterurl"):
            self.datasets["twitterurl"] = _parse_twitter_rows(
                os.path.join(datasets_dir, "Twitter_URL_Corpus_test.txt"), "url")
        if dname in ("all", "pit"):
            self.datasets["pit"] = _parse_twitter_rows(
                os.path.join(datasets_dir, "test.data"), "pit")

    def run(self, eval_type: str = "test", normalize: bool = True) -> Dict[str, float]:
        results: Dict[str, float] = {}
        for dname, rows in self.datasets.items():
            e1 = _embed(self.semb_fn, [r[0] for r in rows], normalize)
            e2 = _embed(self.semb_fn, [r[1] for r in rows], normalize)
            n1 = e1 / np.clip(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12, None)
            n2 = e2 / np.clip(np.linalg.norm(e2, axis=1, keepdims=True), 1e-12, None)
            pred = np.sum(n1 * n2, axis=1)
            labeled = [(r[2], p) for r, p in zip(rows, pred) if r[2] is not None]
            results[f"ap_twitter_{dname}"] = _sklearn_ap(
                [l for l, _ in labeled], [p for _, p in labeled])
            results[f"spearman_twitter_{dname}"] = spearman(
                [r[3] for r in rows], pred.tolist())
        if len(self.datasets) > 1:
            results["ap_twitter_avg"] = float(np.mean(
                [v for k, v in results.items() if k.startswith("ap_twitter_")]))
            results["spearman_twitter_avg"] = float(np.mean(
                [v for k, v in results.items() if k.startswith("spearman_twitter_")]))
        return _round(results)


# ---------------------------------------------------------------------------
# SciDocs
# ---------------------------------------------------------------------------

def _trec_rank(run: Dict[str, float]):
    """trec_eval ordering: score descending, ties by DESCENDING doc id
    (trec_eval sorts docno descending within equal scores; ascending-id
    tie-break diverged from the reference exactly on tied scores)."""
    by_id_desc = sorted(run.items(), key=lambda x: x[0], reverse=True)
    return sorted(by_id_desc, key=lambda x: -x[1])  # stable


def _trec_map(rel: Dict[str, int], run: Dict[str, float]) -> float:
    """Untruncated trec_eval 'map' (binary rel>0, / total relevant)."""
    pos = {d for d, g in rel.items() if g > 0}
    if not pos:
        return 0.0
    ranked = _trec_rank(run)
    hits, ap = 0, 0.0
    for i, (d, _) in enumerate(ranked):
        if d in pos:
            hits += 1
            ap += hits / (i + 1)
    return ap / len(pos)


def _trec_ndcg(rel: Dict[str, int], run: Dict[str, float]) -> float:
    """Untruncated trec_eval 'ndcg' (graded gains, log2 discount)."""
    ranked = _trec_rank(run)
    dcg = sum(rel.get(d, 0) / np.log2(i + 2) for i, (d, _) in enumerate(ranked))
    ideal = sum(g / np.log2(i + 2)
                for i, g in enumerate(sorted(rel.values(), reverse=True)) if g > 0)
    return float(dcg / ideal) if ideal > 0 else 0.0


class SciDocsEvaluator:
    name = "scidocs"
    main_metric = "map_scidocs_cosine_avg"

    def __init__(self, semb_fn: SembFn, datasets_dir: str):
        self.semb_fn = semb_fn
        with open(os.path.join(datasets_dir, "data.json")) as f:
            self.data = json.load(f)

    def _title(self, pid: str) -> Optional[str]:
        """None = paper absent from the corpus; '' = present but untitled
        (the reference embeds untitled papers as empty strings,
        scidocs.py:32-47 — they must NOT be dropped like absent ones)."""
        e = self.data["corpus"].get(pid)
        return (e["title"] or "") if e else None

    def run(self, eval_type: str = "test", normalize: bool = True) -> Dict[str, float]:
        qrels = self.data[eval_type]
        # single embedding pass over every pid with a title
        pids = sorted({p for qrel in qrels.values()
                       for qid, docs in qrel.items()
                       for p in [qid, *docs] if self._title(p) is not None})
        emb = _embed(self.semb_fn, [self._title(p) for p in pids], normalize)
        index = {p: i for i, p in enumerate(pids)}

        results: Dict[str, float] = {}
        for dname, qrel in qrels.items():
            maps_c, ndcgs_c, maps_e, ndcgs_e = [], [], [], []
            for qid, doc_dict in qrel.items():
                if self._title(qid) is None:
                    continue
                dids = [d for d in doc_dict if self._title(d) is not None]
                if not dids:
                    continue
                q = emb[index[qid]]
                D = emb[[index[d] for d in dids]]
                # explicit cosine normalization (redundant when normalize=True
                # but required when False; euclidean below uses the raw emb,
                # so the flag still matters there)
                qe = q / max(np.linalg.norm(q), 1e-12)
                De = D / np.clip(np.linalg.norm(D, axis=1, keepdims=True), 1e-12, None)
                cos = De @ qe
                euc = -np.linalg.norm(D - q, axis=1)
                rel = {d: doc_dict[d] for d in dids}
                maps_c.append(_trec_map(rel, dict(zip(dids, cos.tolist()))))
                ndcgs_c.append(_trec_ndcg(rel, dict(zip(dids, cos.tolist()))))
                maps_e.append(_trec_map(rel, dict(zip(dids, euc.tolist()))))
                ndcgs_e.append(_trec_ndcg(rel, dict(zip(dids, euc.tolist()))))
            results[f"map_scidocs_{dname}_cosine"] = float(np.mean(maps_c))
            results[f"ndcg_scidocs_{dname}_cosine"] = float(np.mean(ndcgs_c))
            results[f"map_scidocs_{dname}_euclidean"] = float(np.mean(maps_e))
            results[f"ndcg_scidocs_{dname}_euclidean"] = float(np.mean(ndcgs_e))
        for metric in ("map", "ndcg"):
            for dist in ("cosine", "euclidean"):
                results[f"{metric}_scidocs_{dist}_avg"] = float(np.mean(
                    [results[f"{metric}_scidocs_{d}_{dist}"] for d in qrels]))
        return _round(results)


# ---------------------------------------------------------------------------
# Orchestration (evaluating.py:31-68)
# ---------------------------------------------------------------------------

EVALUATORS = {e.name: e for e in
              (AskubuntuEvaluator, CQADupStackEvaluator, TwitterParaEvaluator,
               SciDocsEvaluator)}


def run_on(dataset_name: str, semb_fn: SembFn, eval_type: str = "test",
           data_eval_path: str = "./data-eval") -> Dict[str, float]:
    cls = EVALUATORS[dataset_name.lower()]
    return cls(semb_fn, os.path.join(data_eval_path, cls.name)).run(eval_type)


def run(semb_fns: Dict[str, SembFn], eval_type: str = "test",
        data_eval_path: str = "./data-eval", normalize: bool = True,
        output_dir: Optional[str] = None):
    """semb_fns: {task_name: semb_fn} (one fn may serve all four tasks)."""
    results, mains = {}, {}
    for name, cls in EVALUATORS.items():
        if name not in semb_fns:
            continue
        ev = cls(semb_fns[name], os.path.join(data_eval_path, name))
        res = ev.run(eval_type, normalize=normalize)
        results[name] = res
        mains[name] = res[cls.main_metric]
    if mains:
        mains["avg"] = sum(mains.values()) / len(mains)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "results.detailed.json"), "w") as f:
            json.dump(results, f, indent=4)
        with open(os.path.join(output_dir, "results.average_precision.json"), "w") as f:
            json.dump(mains, f, indent=4)
    return results, mains
