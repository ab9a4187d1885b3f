"""OpenAI-compatible embeddings client and dataset fetch helpers.

The port's own copy of `sgpt_tpu/baselines/openai_client.py`, with the same
behaviour: the port imports nothing of the JAX package. Kept OFF by default
for zero-egress environments:

  * `OpenAIEmbedClient` — stdlib-urllib client for any /v1/embeddings-shaped
    endpoint (OpenAI or compatible). No `openai` package dependency. It IS the
    `embed_fn` `baselines.OpenAIRetriever` takes, so the whole reference
    pipeline (batching, thread fan-out, retry, per-chunk caching) applies.
  * `fetch_beir_dataset` — download and unzip a BEIR dataset
    (`beir_retriever --download`).
  * `fetch_useb_data` — download and unzip the USEB data
    (`useb_retriever --download`).

Nothing touches the network on import, and nothing fetches what is already
on disk; each raises clearly when no credentials or connectivity exist.
"""
from __future__ import annotations

import json
import logging
import os
import urllib.request
import zipfile
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)

DEFAULT_BASE_URL = "https://api.openai.com/v1"


class OpenAIEmbedClient:
    """Callable (texts, is_query) -> list of embedding vectors.

    Mirrors the reference's query/doc engine split (call_gpt_api selects the
    -query vs -doc engine per input kind, beir_openai_*.py:193-266): pass
    `query_model` / `doc_model` to use asymmetric search engines, or just
    `model` for a symmetric one.
    """

    def __init__(self, *, api_key: Optional[str] = None,
                 base_url: str = DEFAULT_BASE_URL,
                 model: str = "text-embedding-3-small",
                 query_model: Optional[str] = None,
                 doc_model: Optional[str] = None,
                 timeout: float = 60.0):
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY")
        if not self.api_key:
            raise ValueError(
                "no API key: pass api_key= or set OPENAI_API_KEY. (This "
                "adapter is default-off so the framework stays zero-egress; "
                "inject a fake embed_fn into OpenAIRetriever for offline use.)")
        self.base_url = base_url.rstrip("/")
        self.query_model = query_model or model
        self.doc_model = doc_model or model
        self.timeout = timeout

    def __call__(self, texts: Sequence[str], is_query: bool) -> List[List[float]]:
        payload = json.dumps({
            "model": self.query_model if is_query else self.doc_model,
            "input": list(texts),
        }).encode()
        req = urllib.request.Request(
            self.base_url + "/embeddings", data=payload,
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = json.loads(resp.read())
        # response rows carry an index; order by it (the API may reorder)
        data = sorted(body["data"], key=lambda d: d["index"])
        if len(data) != len(texts):
            raise RuntimeError(
                f"embeddings API returned {len(data)} rows for {len(texts)} "
                "inputs")
        return [d["embedding"] for d in data]


BEIR_DATASET_URL = ("https://public.ukp.informatik.tu-darmstadt.de/thakur/"
                    "BEIR/datasets")


def _http_download(url: str, path: str, *, timeout: float = 120.0,
                   sha256: Optional[str] = None) -> None:
    """Stream url -> path via a `_part` temp (the reference's http_get rename
    contract, useb/downloading.py:7-32: a crashed download never leaves a
    plausible-looking file). With sha256, verify BEFORE the rename."""
    import hashlib

    part = path + "_part"
    digest = hashlib.sha256()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                open(part, "wb") as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                digest.update(chunk)
                f.write(chunk)
    except Exception as e:
        if os.path.exists(part):
            os.remove(part)
        raise RuntimeError(
            f"could not fetch {url!r} ({e!r}) - on a zero-egress box, place "
            "the data on disk yourself (see the caller's docstring)") from e
    if sha256 is not None and digest.hexdigest() != sha256:
        os.remove(part)
        raise RuntimeError(
            f"checksum mismatch for {url!r}: got {digest.hexdigest()}, "
            f"expected {sha256} - refusing a corrupt/tampered archive")
    os.replace(part, path)


def _safe_extract(zip_path: str, out_dir: str) -> None:
    """extractall with a zip-slip guard (member paths must stay inside
    out_dir; a hostile archive must not write elsewhere)."""
    out_real = os.path.realpath(out_dir)
    with zipfile.ZipFile(zip_path) as z:
        for m in z.namelist():
            dest = os.path.realpath(os.path.join(out_dir, m))
            if not (dest == out_real or dest.startswith(out_real + os.sep)):
                raise RuntimeError(f"archive member escapes out_dir: {m!r}")
        z.extractall(out_dir)


def fetch_beir_dataset(name: str, out_dir: str = "./datasets",
                       base_url: Optional[str] = None,
                       sha256: Optional[str] = None) -> str:
    """Download and unzip a BEIR dataset; returns the dataset directory.

    The reference calls beir.util.download_and_unzip with the same bucket
    (beir_dense_retriever.py GenericDataLoader expects the unzipped layout).
    Skips the download if the dataset directory already exists. Pass the
    published zip sha256 to verify the archive before extraction."""
    if base_url is None:
        base_url = BEIR_DATASET_URL  # late-bound: module-level override works
    target = os.path.join(out_dir, name)
    if os.path.isdir(target):
        logger.info("dataset %s already present at %s", name, target)
        return target
    os.makedirs(out_dir, exist_ok=True)
    zip_path = os.path.join(out_dir, f"{name}.zip")
    url = f"{base_url}/{name}.zip"
    logger.info("downloading %s -> %s", url, zip_path)
    _http_download(url, zip_path, sha256=sha256)
    _safe_extract(zip_path, out_dir)
    os.remove(zip_path)
    if not os.path.isdir(target):
        raise RuntimeError(f"archive did not contain {name}/ (got {out_dir})")
    return target


USEB_DATA_URL = ("https://public.ukp.informatik.tu-darmstadt.de/kwang/"
                 "unsupse-benchmark/tsdae-evaluation")


def fetch_useb_data(which: str = "eval", out_dir: str = ".",
                    base_url: Optional[str] = None,
                    sha256: Optional[dict] = None) -> List[str]:
    """Download + unzip the USEB benchmark data (data-train / data-eval).

    Mirrors the reference's useb/downloading.py __main__ (same two archives,
    same 'train'/'eval'/'all' selector, same unzip-into-cwd layout that
    evaluation/useb.py expects). Default-OFF for zero-egress environments:
    nothing fetches unless this is called, and a dataset already on disk
    short-circuits. base_url: `USEB_DATA_URL` when None (read at call time,
    so a module-level override works). sha256: optional {archive_stem:
    hexdigest} map. Returns the extracted data directories."""
    if which not in ("train", "eval", "all"):
        raise ValueError(f"which={which!r}: expected 'train', 'eval' or 'all'")
    if base_url is None:
        base_url = USEB_DATA_URL
    stems = {"train": ["data-train"], "eval": ["data-eval"],
             "all": ["data-train", "data-eval"]}[which]
    out: List[str] = []
    os.makedirs(out_dir, exist_ok=True)
    for stem in stems:
        # both archives extract into a shared top-level data/ tree
        # (data/{train,eval}/...), mirroring downloading.py's unzip-to-cwd
        marker = os.path.join(out_dir, "data", stem.split("-")[1])
        if os.path.isdir(marker):
            logger.info("%s already present at %s", stem, marker)
            out.append(marker)
            continue
        zip_path = os.path.join(out_dir, f"{stem}.zip")
        url = f"{base_url}/{stem}.zip"
        logger.info("downloading %s -> %s", url, zip_path)
        _http_download(url, zip_path,
                       sha256=(sha256 or {}).get(stem))
        _safe_extract(zip_path, out_dir)
        os.remove(zip_path)
        out.append(marker)
    return out
