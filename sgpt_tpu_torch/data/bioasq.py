"""BioASQ → BEIR-format conversion.

Clean-room equivalent of the reference's BioASQ preprocessing notebook
(crossencoder/beir/crossencoder_bioasq_bm25.ipynb cells 4-6):

  * `convert_corpus`: stream allMeSH_2020.json (too large for memory — one
    article per line after the header) into corpus.jsonl rows
    {_id: pmid, title, text: abstractText}; optionally append the BEIR
    authors' manual-fixes.csv (ID, TITLE, TEXT rows).
  * `convert_queries`: BioASQ question files → queries.jsonl +
    qrels/test.tsv. Accepts either the golden test directory
    (Task8BGoldenEnriched/*.json, the 500-query BEIR split) or a single
    training8b.json. Relevance is 1 per linked document; doc ids are the
    trailing path segment of each document URL.

Robustness beyond the notebook: each corpus line is parsed as JSON first
(trailing list commas stripped) and only falls back to the notebook's
string-index extraction for malformed lines.

The port's own copy of `sgpt_tpu/data/bioasq.py`, with the same behaviour: the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import csv
import json
import logging
import os
from typing import Iterable, Optional, Tuple

logger = logging.getLogger(__name__)


def _parse_allmesh_line(line: str) -> Optional[dict]:
    line = line.strip()
    if not line or line in ("{", "}", "]}", '{"articles":['):
        return None
    body = line.rstrip(",")
    try:
        obj = json.loads(body)
        if not isinstance(obj, dict) or "pmid" not in obj:
            return None
        return {"_id": str(obj["pmid"]), "title": obj.get("title", ""),
                "text": obj.get("abstractText", "")}
    except json.JSONDecodeError:
        pass
    # notebook-style raw extraction for malformed lines
    start_txt, start_pmid, start_title = ('"abstractText":"', '","pmid":"',
                                          '","title":"')
    txt_idx, pmid_idx, title_idx = (line.find(start_txt), line.find(start_pmid),
                                    line.find(start_title))
    if txt_idx == -1 or pmid_idx == -1:
        return None
    text = line[txt_idx + len(start_txt): pmid_idx]
    if title_idx == -1:  # no title marker: pmid runs to the closing quote
        pmid = line[pmid_idx + len(start_pmid):]
        pmid = pmid[: pmid.find('"')] if '"' in pmid else pmid
        return {"_id": pmid, "title": "", "text": text}
    pmid = line[pmid_idx + len(start_pmid): title_idx]
    title = line[title_idx + len(start_title):]
    end = title.find('."}')
    return {"_id": pmid, "title": title[:end] if end != -1 else title,
            "text": text}


def convert_corpus(allmesh_path: str, out_corpus: str,
                   manual_fixes_csv: Optional[str] = None) -> int:
    """Stream the corpus; returns the number of documents written."""
    n = 0
    with open(out_corpus, "w") as out:
        with open(allmesh_path, encoding="utf8", errors="ignore") as f:
            for i, line in enumerate(f):
                if i == 0:  # header line carries no article
                    continue
                row = _parse_allmesh_line(line)
                if row is not None:
                    out.write(json.dumps(row) + "\n")
                    n += 1
        if manual_fixes_csv:
            with open(manual_fixes_csv) as f:
                for row in csv.reader(f):  # ID, TITLE, TEXT
                    out.write(json.dumps({"_id": row[0], "title": row[1],
                                          "text": row[2]}) + "\n")
                    n += 1
    logger.info("wrote %d corpus docs to %s", n, out_corpus)
    return n


def _iter_questions(path: str) -> Iterable[dict]:
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if name.endswith(".json"):
                with open(os.path.join(path, name)) as f:
                    yield from json.load(f)["questions"]
    else:
        with open(path) as f:
            yield from json.load(f)["questions"]


def convert_queries(questions_path: str, out_queries: str,
                    out_qrels: str) -> Tuple[int, int]:
    """questions_path: golden-test dir or training json. Returns
    (n_queries, n_qrels)."""
    os.makedirs(os.path.dirname(out_qrels) or ".", exist_ok=True)
    nq = nr = 0
    with open(out_queries, "w") as q_out, open(out_qrels, "w") as r_out:
        r_out.write("query-id\tcorpus-id\tscore\n")
        for question in _iter_questions(questions_path):
            q_out.write(json.dumps({"_id": question["id"],
                                    "text": question["body"]}) + "\n")
            nq += 1
            for doc_url in question.get("documents", []):
                doc_id = doc_url.rstrip("/").split("/")[-1]
                r_out.write(f"{question['id']}\t{doc_id}\t1\n")
                nr += 1
    logger.info("wrote %d queries, %d qrels", nq, nr)
    return nq, nr


def convert(allmesh_path: str, questions_path: str, out_dir: str,
            manual_fixes_csv: Optional[str] = None) -> None:
    """Full conversion into a BEIR-layout directory (corpus.jsonl,
    queries.jsonl, qrels/test.tsv) loadable by evaluation.load_beir_dataset."""
    os.makedirs(os.path.join(out_dir, "qrels"), exist_ok=True)
    convert_corpus(allmesh_path, os.path.join(out_dir, "corpus.jsonl"),
                   manual_fixes_csv)
    convert_queries(questions_path, os.path.join(out_dir, "queries.jsonl"),
                    os.path.join(out_dir, "qrels", "test.tsv"))
