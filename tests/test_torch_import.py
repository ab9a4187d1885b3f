"""`sgpt_tpu_torch` never imports jax nor the JAX package: in a process
where neither `jax` nor `sgpt_tpu` can be imported, the whole package
imports (serving and the CLIs included), and a tiny CPU encode, a
stack-pooled (`meanmean`) encode at a layer index with a dense head, an
`SGPTModel` save/load round trip, a flash (`use_flash`) encode, two index
searches, a DenseRetriever search, a SearchService search and a
cross-encoder score (bucketed and packed rows) run. A scan of the sources finds no import of either."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["sgpt_tpu"] = None  # and so does any import of the JAX package
import importlib, pkgutil
import sgpt_tpu_torch
for m in pkgutil.walk_packages(sgpt_tpu_torch.__path__, "sgpt_tpu_torch."):
    importlib.import_module(m.name)

import torch
from sgpt_tpu_torch.encoder import EmbeddingEngine
from sgpt_tpu_torch.models import Decoder, tiny
from sgpt_tpu_torch.tokenization import SimpleTokenizer

cfg = tiny("neo", num_layers=2, hidden_size=32, num_heads=2)
model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu", specb=True,
                         max_seq_len=64, batch_size=4, normalize_embeddings=True)
emb = engine.encode(["a short text", "a longer text " * 20, "x"])
assert emb.shape == (3, 32), emb.shape
assert abs(float((emb ** 2).sum(1).max()) - 1) < 1e-5
head = [{"w": torch.full((32, 8), 0.1), "activation": "gelu", "location": "post_pool"}]
stack = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                        method="meanmean", layeridx=1, max_seq_len=64, dense_heads=head
                        ).encode(["a short text", "x"])
assert stack.shape == (2, 8), stack.shape
import tempfile
from sgpt_tpu_torch.model import SGPTModel
sgpt = SGPTModel(model, cfg, SimpleTokenizer(cfg.vocab_size), layeridx=1, dense_heads=head,
                 max_seq_len=64, device="cpu")
with tempfile.TemporaryDirectory() as d:
    sgpt.save(d)
    again = SGPTModel.load(d, device="cpu").encode(["a short text", "x"])
assert (again == sgpt.encode(["a short text", "x"])).all()
fcfg = cfg.replace(use_flash=True)
fmodel = Decoder(fcfg, device="cpu", generator=torch.Generator().manual_seed(0))
femb = EmbeddingEngine(fmodel, fcfg, SimpleTokenizer(cfg.vocab_size), device="cpu", specb=True,
                       max_seq_len=128, batch_size=2, normalize_embeddings=True
                       ).encode(["a text long enough " * 10, "short"])
assert femb.shape == (2, 32) and abs(float((femb ** 2).sum(1).max()) - 1) < 1e-5

# search: a "pallas" (K5's plain version on the CPU) and a blockmax index
from sgpt_tpu_torch.index import DenseIndex
from sgpt_tpu_torch.retrieval import DenseRetriever
from sgpt_tpu_torch.serving import SearchService

hits = []
for kernel in ("pallas", "blockmax"):
    index = DenseIndex(32, kernel=kernel, dtype=torch.float32, device="cpu")
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

# the cross-encoder: bucketed rows, and packed rows (K1's segment masks)
from sgpt_tpu_torch.crossencoder import CrossEncoderRanker

pairs = [("a short text", "a document about a short text"), ("x", "y " * 30), ("x", "z")]
ce = [CrossEncoderRanker(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                         max_length=64, pack_t=pack_t).predict(pairs) for pack_t in (None, 64)]
assert all(abs(a - b) < 1e-4 and a < 0 for a, b in zip(*ce)), ce
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "sgpt_tpu") and sys.modules[m] is not None]
print("OK")
"""


def test_port_imports_and_encodes_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


# an import of jax or of the JAX package, in any form: `import` statements,
# `importlib` by name, and `find_spec` / `spec_from_file_location` lookups
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|sgpt_tpu)(\.|\s|$)"
    r"|(import_module|find_spec|__import__)\(\s*[\"'](jax|sgpt_tpu)([\"'.])"
    r"|sgpt_tpu\.baselines")


@pytest.mark.parametrize("root", ["sgpt_tpu_torch", "chip_smoke.py", "chip_variants.py"])
def test_port_sources_import_no_jax_nor_the_jax_package(root):
    paths = [REPO / root] if root.endswith(".py") else sorted((REPO / root).rglob("*.py"))
    assert paths
    for path in paths:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not FORBIDDEN.search(line), f"{path}:{n}: {line}"
