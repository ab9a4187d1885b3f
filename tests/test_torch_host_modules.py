"""The port's copies of the JAX package's host modules == the originals.

`sgpt_tpu_torch.tokenization`, `.data`, `.evaluation`, `.baselines`,
`.ce_prompts` and `.retrieval_bm25` are copies, so that the port imports
nothing of the JAX package. Each case runs
the same inputs through the copy and the original and asserts equal
results (exactly: these modules do no floating-point work that could
differ, and the native engines are the same C++ sources).
"""
import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")
# two cases import JAX-side modules that import jax; they keep it on the CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sgpt_tpu.data as jdata  # noqa: E402
import sgpt_tpu.evaluation as jeval  # noqa: E402
import sgpt_tpu.tokenization as jtok  # noqa: E402
import sgpt_tpu_torch.data as pdata  # noqa: E402
import sgpt_tpu_torch.evaluation as peval  # noqa: E402
import sgpt_tpu_torch.tokenization as ptok  # noqa: E402
from sgpt_tpu.data import jsonl_native as jjsonl  # noqa: E402
from sgpt_tpu.evaluation.aggregate import CQADUPSTACK_FORUMS  # noqa: E402
from sgpt_tpu.tokenization import specb as jspecb  # noqa: E402
from sgpt_tpu_torch.data import jsonl_native as pjsonl  # noqa: E402
from sgpt_tpu_torch.tokenization import specb as pspecb  # noqa: E402


def _texts(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(m))
           for m in rng.integers(0, 90, n)]
    out[1] = "line one\nline two\n\nTHREE"
    return out


def test_tokenization_exports_the_same_names():
    assert set(ptok.__all__) == set(jtok.__all__)
    assert ptok.GPT2_BRACKET_IDS == jtok.GPT2_BRACKET_IDS
    assert pspecb.DEFAULT_BUCKETS == jspecb.DEFAULT_BUCKETS
    assert pspecb.ROW_BUCKETS == jspecb.ROW_BUCKETS
    assert type(ptok.get_tokenizer(None, vocab_size=77)).__name__ == "SimpleTokenizer"


@pytest.mark.parametrize("specb", [False, True])
@pytest.mark.parametrize("is_query", [False, True])
@pytest.mark.parametrize("max_seq_len", [16, 64])
def test_specb_codec_matches(specb, is_query, max_seq_len):
    texts = _texts(max_seq_len)
    p = pspecb.SpecbCodec(ptok.SimpleTokenizer(500), max_seq_len=max_seq_len, specb=specb)
    j = jspecb.SpecbCodec(jtok.SimpleTokenizer(500), max_seq_len=max_seq_len, specb=specb)
    prow = p.encode_rows(texts, is_query=is_query)
    assert prow == j.encode_rows(texts, is_query=is_query)
    assert prow[1] > 0  # some texts truncate
    for pad_to in (None, max_seq_len):
        a = p.pad_rows(prow[0], pad_to=pad_to, n_trunc=prow[1], toks_trunc=prow[2])
        b = j.pad_rows(prow[0], pad_to=pad_to, n_trunc=prow[1], toks_trunc=prow[2])
        for f in ("input_ids", "attention_mask", "lengths"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n_truncated, a.tokens_truncated) == (b.n_truncated, b.tokens_truncated)
    a = pspecb.encode_batch(ptok.SimpleTokenizer(500), texts[:5], specb=specb, max_seq_len=32)
    b = jspecb.encode_batch(jtok.SimpleTokenizer(500), texts[:5], specb=specb, max_seq_len=32)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)


@pytest.mark.parametrize("cap", [64, 300, 2048])
def test_pick_bucket_and_row_bucket_match(cap):
    for n in range(1, 2100, 7):
        assert (pspecb.pick_bucket(n, pspecb.DEFAULT_BUCKETS, cap)
                == jspecb.pick_bucket(n, jspecb.DEFAULT_BUCKETS, cap))
    for n in range(1, 700):
        for over in (False, True):
            assert pspecb.row_bucket(n, over) == jspecb.row_bucket(n, over)


def _qrels_results(seed):
    rng = np.random.default_rng(seed)
    docs = [f"d{i}" for i in range(60)]
    qrels, results = {}, {}
    for q in range(25):
        rel = rng.choice(docs, size=int(rng.integers(0, 5)), replace=False)
        qrels[f"q{q}"] = {d: int(rng.integers(0, 3)) for d in rel}
        # ties on purpose: scores rounded to one decimal
        results[f"q{q}"] = {d: float(np.round(rng.random(), 1))
                            for d in rng.choice(docs, size=30, replace=False)}
    return qrels, results


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_retrieval_matches(seed):
    qrels, results = _qrels_results(seed)
    k = (1, 3, 10, 100)
    assert peval.evaluate_retrieval(qrels, results, k) == jeval.evaluate_retrieval(qrels, results, k)
    assert (peval.EvaluateRetrieval.evaluate(qrels, results, k)
            == jeval.EvaluateRetrieval.evaluate(qrels, results, k))
    for metric in ("mrr", "acc"):
        assert (peval.EvaluateRetrieval.evaluate_custom(qrels, results, k, metric)
                == jeval.EvaluateRetrieval.evaluate_custom(qrels, results, k, metric))
    x, y = np.random.default_rng(seed).random((2, 30)).tolist()
    assert peval.spearman(x, y) == jeval.spearman(x, y)


def test_results_store_matches(tmp_path):
    stores = [mod.ResultsStore(str(tmp_path / f"{name}.json"))
              for name, mod in (("port", peval), ("jax", jeval))]
    rng = np.random.default_rng(5)
    datasets = ["nfcorpus", "fiqa", "arguana", "scidocs", "scifact", "msmarco"]
    datasets += [f"cqadupstack_{f}" for f in CQADUPSTACK_FORUMS]
    for model in ("m/a_100", "m/a_200", "m/b"):
        for d in datasets:
            metrics = [{f"NDCG@{k}": float(rng.random()) for k in (1, 10)} for _ in range(4)]
            for store in stores:
                store.add(model, d, *metrics)
    for store in stores:
        store.compute_model_avg()
    assert stores[0].data == stores[1].data
    assert stores[0].select_best_ckpt() == stores[1].select_best_ckpt()
    assert stores[0].rank_models() == stores[1].rank_models()
    for store in stores:
        store.save()
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))


def test_extract_fields_and_beir_loader_match(tmp_path, monkeypatch):
    # The JAX module builds into native/ in place (`make -B`), as do other
    # JAX modules that other test processes load at the same time; a load
    # during such a rebuild finds a missing or partly written library and
    # falls back to another backend. The reference therefore builds from a
    # private copy of the sources here (the port builds into its own
    # directory under a lock: sgpt_tpu_torch/native_build.py).
    private = tmp_path / "native"
    shutil.copytree(jjsonl._NATIVE_DIR, private,
                    ignore=lambda d, names: [n for n in names if n.endswith(".so")])
    monkeypatch.setattr(jjsonl, "_NATIVE_DIR", str(private))
    for name, value in (("_TRIED", False), ("_BACKEND", None), ("_PYMOD", None), ("_LIB", None)):
        monkeypatch.setattr(jjsonl, name, value)
    root = tmp_path / "ds"
    (root / "qrels").mkdir(parents=True)
    rows = [{"_id": "d1", "title": "T", "text": "a \"quoted\" text\nwith a newline"},
            {"_id": 2, "text": "numeric id", "extra": [1, 2]},
            {"_id": "d3", "title": None, "text": "ünïcode"}]
    (root / "corpus.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    (root / "queries.jsonl").write_text(json.dumps({"_id": "q1", "text": "query"}) + "\n")
    (root / "qrels" / "test.tsv").write_text("query-id\tcorpus-id\tscore\nq1\td1\t1\n")
    fields = ("_id", "title", "text", "missing")
    got = pjsonl.extract_fields(str(root / "corpus.jsonl"), fields)
    assert got == jjsonl.extract_fields(str(root / "corpus.jsonl"), fields)
    assert pjsonl.backend() == jjsonl.backend()
    assert peval.load_beir_dataset(str(root)) == jeval.load_beir_dataset(str(root))


def test_native_build_runs_once_for_concurrent_callers(tmp_path, monkeypatch):
    """Builders racing on a fresh tree get one complete library, built once."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from sgpt_tpu_torch import native_build

    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path)
    with ThreadPoolExecutor(4) as pool:
        paths = set(pool.map(lambda _: native_build.build("libjsonl_fields.so"), range(4)))
    assert len(paths) == 1
    (out_dir,) = tmp_path.iterdir()
    assert sorted(p.name for p in out_dir.iterdir()) == [".lock", "libjsonl_fields.so"]
    assert ctypes.CDLL(paths.pop()).jsonl_extract


def test_serve_corpus_loader_reads_the_jsonl_as_the_jax_cli(tmp_path):
    pytest.importorskip("jax")
    from sgpt_tpu.cli.serve import load_jsonl_corpus as jax_load
    from sgpt_tpu_torch.cli.serve import load_jsonl_corpus

    path = tmp_path / "c.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in [
        {"_id": "a", "title": "Title", "text": "body"}, {"id": 7, "text": "only text"},
        {"text": "no id"}]))
    assert load_jsonl_corpus(str(path)) == jax_load(str(path))


def test_msmarco_triplets_and_batcher_match():
    queries = {f"q{i}": f"query {i}" for i in range(12)}
    corpus = {f"p{i}": f"passage {i}" for i in range(40)}
    qrels = {f"q{i}": {"pos": [f"p{i}", f"p{i + 12}"], "neg": [f"p{(i * 7) % 40}",
                                                              f"p{(i * 3 + 1) % 40}"]}
             for i in range(12)}
    qrels["q0"]["neg"] = []  # dropped: no negative
    a = pdata.MSMARCOTriplets(queries, corpus, qrels, seed=3)
    b = jdata.MSMARCOTriplets(queries, corpus, qrels, seed=3)
    for _ in range(3):
        assert [e.texts for e in a.epoch()] == [e.texts for e in b.epoch()]
    negs = [("x", 0.5), ("y", -4.0), ("z", -2.1)]
    assert (pdata.filter_hard_negatives(negs, [1.0, 2.0], max_negs=1)
            == jdata.filter_hard_negatives(negs, [1.0, 2.0], max_negs=1))
    ex = [pdata.InputExample(texts=(f"t{i % 9}", f"u{i}")) for i in range(30)]
    jex = [jdata.InputExample(texts=e.texts) for e in ex]
    pb, jb = pdata.NoDuplicatesBatcher(ex, 4, seed=1), jdata.NoDuplicatesBatcher(jex, 4, seed=1)
    assert [[e.texts for e in x] for x in pb] == [[e.texts for e in x] for x in jb]


def test_ir_evaluator_matches():
    from sgpt_tpu.evaluation.ir import InformationRetrievalEvaluator as J
    from sgpt_tpu_torch.evaluation.ir import InformationRetrievalEvaluator as P

    rng = np.random.default_rng(4)
    table = {f"t{i}": rng.normal(size=8) for i in range(50)}
    queries = {f"q{i}": f"t{i}" for i in range(10)}
    corpus = {f"d{i}": f"t{i}" for i in range(50)}
    rel = {f"q{i}": {f"d{i}", f"d{(i + 1) % 50}"} for i in range(10)}

    def enc(texts):
        return np.stack([table[t] for t in texts])

    kw = dict(corpus_chunk_size=16, map_at=(10,), main_metric="map@10")
    assert P(queries, corpus, rel, **kw).compute(enc) == J(queries, corpus, rel, **kw).compute(enc)


def test_fetch_beir_dataset_finds_a_dataset_on_disk(tmp_path):
    """The download helper returns an existing dataset without a request."""
    pytest.importorskip("jax")
    from sgpt_tpu.baselines.openai_client import fetch_beir_dataset as jax_fetch
    from sgpt_tpu_torch.baselines import fetch_beir_dataset

    (tmp_path / "scifact").mkdir()
    got = fetch_beir_dataset("scifact", out_dir=str(tmp_path), base_url="http://127.0.0.1:9")
    assert got == jax_fetch("scifact", out_dir=str(tmp_path), base_url="http://127.0.0.1:9")
    assert got == str(tmp_path / "scifact")


def test_ce_prompt_registry_and_shot_selection_match():
    import sgpt_tpu.ce_prompts as jcp
    import sgpt_tpu_torch.ce_prompts as pcp

    for name in ("ZERO_SHOT", "FEW_SHOT", "YES_NO", "ALL_PROMPT_IDS"):
        assert getattr(pcp, name) == getattr(jcp, name), name
    rng = np.random.default_rng(9)
    corpus = {f"d{i}": {"title": "", "text": " ".join(f"w{j}" for j in range(int(n)))}
              for i, n in enumerate(rng.integers(1, 30, 40))}
    queries = {f"q{i}": " ".join(f"t{j}" for j in range(int(n)))
               for i, n in enumerate(rng.integers(1, 8, 12))}
    qrels = {f"q{i}": {f"d{int(d)}": int(rng.integers(1, 3))
                       for d in rng.choice(40, 3, replace=False)} for i in range(12)}
    qrels["q99"] = {"d0": 1}  # a query without text is skipped
    for floor in (0, 12):
        got = pcp.select_fewshot(corpus, queries, qrels, ptok.SimpleTokenizer(500),
                                 min_corp_query_len=floor)
        assert got == jcp.select_fewshot(corpus, queries, qrels, jtok.SimpleTokenizer(500),
                                         min_corp_query_len=floor)
    for mod, tok in ((pcp, ptok), (jcp, jtok)):
        with pytest.raises(ValueError, match="no usable"):
            mod.select_fewshot(corpus, queries, {}, tok.SimpleTokenizer(500))


def test_bm25_matches():
    from sgpt_tpu.retrieval_bm25 import BM25Index as J
    from sgpt_tpu.retrieval_bm25 import BM25Retriever as JR
    from sgpt_tpu_torch.retrieval_bm25 import BM25Index as P
    from sgpt_tpu_torch.retrieval_bm25 import BM25Retriever as PR

    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(80)] + ["Alpha", "beta-gamma", "ünï"]
    corpus = {f"d{i}": {"title": "T x" if i % 4 == 0 else "",
                        "text": " ".join(rng.choice(words, int(rng.integers(1, 60))))}
              for i in range(120)}
    queries = {f"q{i}": " ".join(rng.choice(words, int(rng.integers(1, 6))))
               for i in range(20)}
    queries["none"] = "zzz qqq"  # no term in the corpus: no hits
    for kw in ({}, {"k1": 0.9, "b": 0.4}):
        got, want = P.build(corpus, **kw), J.build(corpus, **kw)
        assert (got.doc_ids, got.doc_len, got.avgdl) == (want.doc_ids, want.doc_len,
                                                         want.avgdl)
        for k in (1, 10, 200):
            assert got.search(queries, k) == want.search(queries, k)
        assert PR(**kw).search(corpus, queries, 10) == JR(**kw).search(corpus, queries, 10)
