"""`sgpt_tpu_torch` never imports jax nor the JAX package: in a process
where neither `jax` nor `sgpt_tpu` can be imported, the whole package
imports (serving and the CLIs included), and a tiny CPU encode, a
stack-pooled (`meanmean`) encode at a layer index with a dense head, an
`SGPTModel` save/load round trip, a flash (`use_flash`) encode, BERT, T5
and CLIP encodes, two index
searches, a DenseRetriever search, a SearchService search, meshed encodes
(tp 2, dp 2) and a sharded index search, a
cross-encoder score (bucketed and packed rows), a training step on a dp × tp
mesh, a sequence-parallel (ring attention) training step, encode and TSDAE
step, `mnrl_loss_dp`, the profiling utilities around an encode (a trace
written) and the OpenAI retriever with a fake client run. A scan of the
sources finds no import of either."""
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
import os
import tempfile
from sgpt_tpu_torch.baselines import OpenAIRetriever
from sgpt_tpu_torch.utils import Timer, profile_trace
with tempfile.TemporaryDirectory() as d:
    with profile_trace(d), Timer() as timer:
        engine.encode(["a", "b c", "d"])
    assert [f for f in os.listdir(d) if f.endswith(".pt.trace.json")], os.listdir(d)
assert timer.elapsed > 0
fake = OpenAIRetriever(lambda texts, is_query: [[len(t), 1.0] for t in texts])
assert fake.encode_queries(["ab", "c"]).tolist() == [[2.0, 1.0], [1.0, 1.0]]
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

# the encoder families and the CLIP dual tower
import numpy as np
from sgpt_tpu_torch.models.clip import CLIP, CLIPEncoder, clip_tiny
for family in ("bert", "t5"):
    ecfg = tiny(family, num_layers=1, hidden_size=32, num_heads=2)
    eemb = EmbeddingEngine(Decoder(ecfg, device="cpu"), ecfg, SimpleTokenizer(ecfg.vocab_size),
                           device="cpu", method="mean", max_seq_len=64).encode(["a b", "c"])
    assert eemb.shape == (2, 32) and np.isfinite(eemb).all()
ccfg = clip_tiny()
cemb = CLIPEncoder(CLIP(ccfg, device="cpu"), ccfg, SimpleTokenizer(99)).encode(
    ["a cat", np.zeros((12, 12, 3), np.uint8)])
assert cemb.shape == (2, 24) and np.isfinite(cemb).all()

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

# meshes: a tensor-parallel and a data-parallel encode, a sharded index
from sgpt_tpu_torch.parallel import make_mesh

texts = ["a short text", "a longer text " * 20, "x"]
for dp, tp in ((1, 2), (2, 1)):
    mesh = make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    memb = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), mesh=mesh, specb=True,
                           max_seq_len=64, batch_size=4, normalize_embeddings=True).encode(texts)
    assert abs(memb - emb).max() < 1e-5, (dp, tp, abs(memb - emb).max())
sharded = DenseIndex(32, dtype=torch.float32, mesh=make_mesh(dp=2, devices=["cpu", "cpu"]))
sharded.add(emb, ids=["a", "b", "c"])
assert sharded.build().search_embeddings(emb[1:2], k=2)[1][0][0] == "b"

# the cross-encoder: bucketed rows, and packed rows (K1's segment masks)
from sgpt_tpu_torch.crossencoder import CrossEncoderRanker

pairs = [("a short text", "a document about a short text"), ("x", "y " * 30), ("x", "z")]
ce = [CrossEncoderRanker(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                         max_length=64, pack_t=pack_t).predict(pairs) for pack_t in (None, 64)]
assert all(abs(a - b) < 1e-4 and a < 0 for a, b in zip(*ce)), ce

# training under a dp x tp mesh and sequence parallelism (ring attention)
from sgpt_tpu_torch.losses import mnrl_loss_dp
from sgpt_tpu_torch.ops.ring_attention import ring_attention
from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig, TSDAETrainer

sp = make_mesh(dp=2, devices=["cpu", "cpu"])
batch = [("a b", "a c", "x y"), ("d e", "d f", "z w")]
for kw in (dict(mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4)), dict(sp_mesh=sp)):
    trainer = ContrastiveTrainer(Decoder(cfg, device="cpu"), cfg, SimpleTokenizer(cfg.vocab_size),
                                 TrainConfig(batch_size=2, max_seq_len=16), **kw)
    assert np.isfinite(trainer.fit(lambda: iter([batch]), 1)["history"][0]["loss"])
sp_emb = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), sp_mesh=sp, specb=True,
                         max_seq_len=64, batch_size=4, normalize_embeddings=True).encode(texts)
assert abs(sp_emb - emb).max() < 1e-5, abs(sp_emb - emb).max()
assert np.isfinite(TSDAETrainer(Decoder(cfg, device="cpu"), cfg, SimpleTokenizer(cfg.vocab_size),
                                max_seq_len=16, sp_mesh=sp).train_batch([("a b", "a b c")]))
x = torch.randn(1, 2, 8, 4)
assert ring_attention(x, x, x, torch.ones(1, 8), mesh=sp).shape == x.shape
assert len(mnrl_loss_dp([x[0, 0], x[0, 1]], [x[0, 1], x[0, 0]])) == 2
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
