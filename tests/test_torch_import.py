"""`sgpt_tpu_torch` never imports jax: in a process where jax cannot be
imported, the whole package imports (serving and the CLIs included), and a
tiny CPU encode, two index searches, a DenseRetriever search and a
SearchService search run."""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import importlib, pkgutil
import sgpt_tpu_torch
for m in pkgutil.walk_packages(sgpt_tpu_torch.__path__, "sgpt_tpu_torch."):
    importlib.import_module(m.name)

import torch
from sgpt_tpu.tokenization import SimpleTokenizer
from sgpt_tpu_torch.encoder import EmbeddingEngine
from sgpt_tpu_torch.models import Decoder, tiny

cfg = tiny("neo", num_layers=2, hidden_size=32, num_heads=2)
model = Decoder(cfg, generator=torch.Generator().manual_seed(0))
engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), specb=True,
                         max_seq_len=64, batch_size=4, normalize_embeddings=True)
emb = engine.encode(["a short text", "a longer text " * 20, "x"])
assert emb.shape == (3, 32), emb.shape
assert abs(float((emb ** 2).sum(1).max()) - 1) < 1e-5

# search: a "pallas" (K5's plain version on the CPU) and a blockmax index
from sgpt_tpu_torch.index import DenseIndex
from sgpt_tpu_torch.retrieval import DenseRetriever
from sgpt_tpu_torch.serving import SearchService

hits = []
for kernel in ("pallas", "blockmax"):
    index = DenseIndex(32, kernel=kernel, dtype=torch.float32)
    index.add(emb, ids=["a", "b", "c"])
    index.build()
    hits.append(index.search_embeddings(emb[1:2], k=2)[1])
assert hits[0] == hits[1] and hits[0][0][0] == "b", hits
docs = {"a": {"title": "", "text": "a short text"}, "b": {"title": "t", "text": "words " * 9},
        "c": {"title": "", "text": "x"}}
res = DenseRetriever(engine, device_chunk=128).search(docs, {"q": "a short text"}, top_k=2)
assert list(res["q"])[0] == "a", res
svc = SearchService(engine, index_kw={"kernel": "pallas"})
svc.add_documents(["a short text", "x"], ids=["a", "c"])
assert svc.search(["x"], k=1)[0][0]["id"] == "c"
svc.close()
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            if sys.modules[m] is not None]
print("OK")
"""


def test_port_imports_and_encodes_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_name_no_jax():
    for path in (REPO / "sgpt_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), (path, line)
