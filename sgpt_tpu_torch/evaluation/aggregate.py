"""Results accumulation & model averaging/selection.

The port's own copy of `sgpt_tpu/evaluation/aggregate.py`, with the same behaviour: the
port imports nothing of the JAX package.

Parity targets in biencoder/beir/beir_dense_retriever.py:
  * per-model×dataset nDCG/MAP/recall/precision accumulation into
    beir_embeddings_ndcgs.json (:448-498)
  * CQADupStack = mean over its 12 forums once all present (:470-495)
  * average / subaverage / subsubaverage dataset sets (:506-541) —
    average excludes MS MARCO (in-domain)
  * best-checkpoint selection by average NDCG@10 across step checkpoints
    (:543-592, generalized: any checkpoint suffixes, not the hardcoded lists)
"""
from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, Iterable, Optional

CQADUPSTACK_FORUMS = (
    "android", "english", "gaming", "gis", "mathematica", "physics",
    "programmers", "stats", "wordpress", "webmasters", "unix", "tex",
)

SUBSUB_AVG_DATASETS = ("nfcorpus", "fiqa", "arguana", "scidocs", "scifact")

SUB_AVG_DATASETS = ("trec-covid", "nfcorpus", "hotpotqa", "fiqa", "arguana",
                    "webis-touche2020", "quora", "dbpedia-entity", "fever",
                    "climate-fever", "scifact")

# excludes msmarco (in-domain)
AVG_DATASETS = ("nfcorpus", "bioasq", "nq", "hotpotqa", "fiqa", "signal1m",
                "trec-news", "arguana", "webis-touche2020", "quora",
                "dbpedia-entity", "scidocs", "fever", "climate-fever", "scifact",
                "robust04", "cqadupstack", "trec-covid")


class ResultsStore:
    """beir_embeddings_ndcgs.json-shaped accumulator."""

    def __init__(self, path: str = "./beir_embeddings_ndcgs.json"):
        self.path = path
        if os.path.exists(path):
            with open(path) as f:
                self.data = json.load(f)
        else:
            self.data = {}
        for key in ("ndcgs", "maps", "recalls", "precisions"):
            self.data.setdefault(key, {})

    def add(self, model_name: str, dataset: str, ndcg: Dict, _map: Dict,
            recall: Dict, precision: Dict):
        model_name = model_name.replace("/", "_")
        dataset = dataset.replace("/", "_")
        for key, metrics in (("ndcgs", ndcg), ("maps", _map),
                             ("recalls", recall), ("precisions", precision)):
            self.data[key].setdefault(model_name, {})[dataset] = metrics
        self._maybe_average_cqadupstack(model_name)

    def _maybe_average_cqadupstack(self, model_name: str):
        nd = self.data["ndcgs"].get(model_name, {})
        if all(f"cqadupstack_{f}" in nd for f in CQADUPSTACK_FORUMS):
            avg: Dict[str, float] = defaultdict(float)
            for forum in CQADUPSTACK_FORUMS:
                for k, v in nd[f"cqadupstack_{forum}"].items():
                    avg[k] += v / len(CQADUPSTACK_FORUMS)
            nd["cqadupstack"] = dict(avg)

    def compute_model_avg(self):
        """Add average/subaverage/subsubaverage entries per model (:512-541)."""
        for model_name, datasets in self.data["ndcgs"].items():
            present = [d for d in datasets if d in AVG_DATASETS]
            for label, required in (("average", present),
                                    ("subaverage", SUB_AVG_DATASETS),
                                    ("subsubaverage", SUBSUB_AVG_DATASETS)):
                if label != "average" and not all(d in present for d in required):
                    continue
                members = present if label == "average" else list(required)
                avg: Dict[str, float] = defaultdict(float)
                for d in members:
                    for k, v in datasets[d].items():
                        avg[k] += v / len(members)
                datasets[label] = dict(avg)

    def select_best_ckpt(self, metric: str = "NDCG@10") -> Dict[str, Dict]:
        """Group models by checkpoint-suffix pattern '<base>_<step>' and keep the
        best by average[metric]."""
        groups: Dict[str, list] = defaultdict(list)
        for model_name, datasets in self.data["ndcgs"].items():
            m = re.match(r"^(.*)_(\d+)$", model_name)
            if m and "average" in datasets:
                groups[m.group(1)].append(model_name)
        best = {}
        for base, members in groups.items():
            top = max(members, key=lambda n: self.data["ndcgs"][n]["average"].get(metric, 0))
            best[top] = self.data["ndcgs"][top]
        return best

    def rank_models(self, metric: str = "NDCG@10", top: int = 5):
        ranked = sorted(
            (m for m, d in self.data["ndcgs"].items() if "average" in d),
            key=lambda m: self.data["ndcgs"][m]["average"].get(metric, 0),
            reverse=True)
        return ranked[:top]

    def save(self):
        with open(self.path, "w") as f:
            json.dump(self.data, f)
