"""Download and unzip a BEIR dataset (`beir_retriever --download`).

The port's own copy of `fetch_beir_dataset` and its two helpers from
`sgpt_tpu/baselines/openai_client.py`, with the same behaviour: the port
imports nothing of the JAX package. Nothing touches the network unless
`fetch_beir_dataset` is called and the dataset is not on disk yet.
"""
from __future__ import annotations

import logging
import os
import urllib.request
import zipfile
from typing import Optional

logger = logging.getLogger(__name__)


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
