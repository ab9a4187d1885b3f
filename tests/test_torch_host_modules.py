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


# ---------------------------------------------------------------------------
# the symmetric-search slice's copies: data/nli.py, readers.py, datasets.py,
# evaluation/sts.py, useb.py, extra.py

def test_data_and_evaluation_export_the_same_names():
    assert set(pdata.__all__) == set(jdata.__all__)
    assert set(peval.__all__) == set(jeval.__all__)


def _nli_rows(rng, n=30):
    rows = []
    for i in range(n):
        p = f"premise {i} " + " ".join(f"w{rng.integers(0, 40)}" for _ in range(3))
        for label in ("entailment", "contradiction", "neutral"):
            for j in range(int(rng.integers(0, 3))):
                rows.append(("train" if i % 5 else "dev", p, f"{label} {i} {j}", label))
    return rows


def test_nli_triplets_and_readers_match(tmp_path):
    import gzip

    rng = np.random.default_rng(21)
    rows = _nli_rows(rng)
    path = tmp_path / "AllNLI.tsv.gz"
    with gzip.open(path, "wt") as f:
        f.write("split\tsentence1\tsentence2\tlabel\n")
        f.writelines("\t".join(r) + "\n" for r in rows)
    for split in ("train", "dev"):
        got = list(pdata.load_nli_tsv(str(path), split))
        assert got == list(jdata.load_nli_tsv(str(path), split)) and got
        for seed in (0, 3):
            a = pdata.build_nli_triplets(got, seed=seed)
            b = jdata.build_nli_triplets(got, seed=seed)
            assert [e.texts for e in a] == [e.texts for e in b] and a
    sts = tmp_path / "sts.tsv"
    sts.write_text("split\tsentence1\tsentence2\tscore\n" + "".join(
        f"{'dev' if i % 2 else 'test'}\ts{i}\tt{i}\t{i % 6}\n" for i in range(12)))
    trip = tmp_path / "trip.tsv"
    trip.write_text("a\tb\tc\n" + "".join(f"a{i}\tp{i}\tn{i}\n" for i in range(9)) + "short\n")
    for kw in ({}, {"max_examples": 3}, {"split": "dev"}):
        for name, fname in (("STSDataReader", "sts.tsv"), ("NLIDataReader", "AllNLI.tsv.gz")):
            a = getattr(pdata, name)(str(tmp_path)).get_examples(fname, **kw)
            b = getattr(jdata, name)(str(tmp_path)).get_examples(fname, **kw)
            assert [(e.texts, e.label) for e in a] == [(e.texts, e.label) for e in b] and a
    for header in (False, True):
        a = pdata.TripletReader(str(tmp_path), has_header=header).get_examples("trip.tsv")
        b = jdata.TripletReader(str(tmp_path), has_header=header).get_examples("trip.tsv")
        assert [e.texts for e in a] == [e.texts for e in b] and a


def test_dataset_batchers_match():
    import random

    sents = [f"sentence {i} " + "word " * (i % 7) for i in range(40)]
    ex = [(f"t{i}", float(i % 4)) for i in range(33)]
    for repl in (False, True):
        a, b = (mod.SentenceLabelBatcher([mod.InputExample(texts=(t,), label=lab)
                                          for t, lab in ex], 8, 2, seed=1, with_replacement=repl)
                for mod in (pdata, jdata))
        assert len(a) == len(b)
        assert [[(e.texts, e.label) for e in x] for x in a] == \
            [[(e.texts, e.label) for e in x] for x in b]
    a = list(pdata.contrastive_tension_batches(sents, 8, 4, seed=2))
    b = list(jdata.contrastive_tension_batches(sents, 8, 4, seed=2))
    assert [[(e.texts, e.label) for e in x] for x in a] == \
        [[(e.texts, e.label) for e in x] for x in b] and a
    a, b = pdata.DenoisingBatcher(sents, 6, seed=4), jdata.DenoisingBatcher(sents, 6, seed=4)
    for _ in range(2):  # the noise changes by epoch
        assert [[e.texts for e in x] for x in a] == [[e.texts for e in x] for x in b]
    assert (pdata.denoise_text("a b c d e", 0.5, random.Random(5))
            == jdata.denoise_text("a b c d e", 0.5, random.Random(5)))
    pp, jp = (mod.ParallelSentencesData(lambda s: [len(t) for t in s], batch_size=3)
              for mod in (pdata, jdata))
    for p in (pp, jp):
        p.add_dataset([["src a", "tgt a1", "tgt a2"], ["src b"], ["src c", "tgt c"]] * 2,
                      max_sentences=7)
    assert pp.pairs == jp.pairs and list(pp.batches()) == list(jp.batches())


def _table_encoder(dim=8, seed=0):
    """A deterministic text → vector map: identical texts, identical rows."""
    import hashlib

    def enc(texts):
        out = []
        for t in texts:
            h = int(hashlib.sha1(t.strip().encode()).hexdigest()[:8], 16)
            out.append(np.random.default_rng(h + seed).normal(size=dim))
        return np.asarray(out, np.float32)

    return enc


def test_sts_and_extra_evaluators_match():
    enc = _table_encoder()
    rng = np.random.default_rng(6)
    s1 = [f"a {i}" for i in range(20)]
    s2 = [f"a {i}" if i % 3 == 0 else f"b {i}" for i in range(20)]
    gold = rng.random(20).tolist()
    pairs = [(pe, je) for pe, je in (
        (peval.EmbeddingSimilarityEvaluator(s1, s2, gold),
         jeval.EmbeddingSimilarityEvaluator(s1, s2, gold)),
        (peval.TripletEvaluator(s1, s2, s1[::-1]), jeval.TripletEvaluator(s1, s2, s1[::-1])),
        (peval.BinaryClassificationEvaluator(s1, s2, [i % 3 == 0 for i in range(20)]),
         jeval.BinaryClassificationEvaluator(s1, s2, [i % 3 == 0 for i in range(20)])),
        (peval.MSEEvaluator(s1, enc(s2)), jeval.MSEEvaluator(s1, enc(s2))),
        (peval.TranslationEvaluator(s1, s2), jeval.TranslationEvaluator(s1, s2)))]
    samples = [{"query": s1[i], "positive": [s2[i]], "negative": s2[i + 1:i + 4]}
               for i in range(10)]
    pairs.append((peval.RerankingEvaluator(samples), jeval.RerankingEvaluator(samples)))
    rows = [{"en": s1[i], "de": s2[i], "fr": "" if i == 2 else s2[-i]} for i in range(10)]
    pairs.append((peval.MSEEvaluatorFromDataFrame(rows, enc, [("en", "de"), ("en", "fr")]),
                  jeval.MSEEvaluatorFromDataFrame(rows, enc, [("en", "de"), ("en", "fr")])))
    pairs.append((peval.SequentialEvaluator([p for p, _ in pairs[:3]]),
                  jeval.SequentialEvaluator([j for _, j in pairs[:3]])))
    for pe, je in pairs:
        assert pe(enc) == je(enc), type(pe).__name__
        if hasattr(pe, "compute"):
            assert pe.compute(enc) == je.compute(enc), type(pe).__name__
    w = rng.normal(size=(24, 3))
    labels = rng.integers(0, 3, 20).tolist()
    got = peval.LabelAccuracyEvaluator(s1, s2, labels)(
        peval.LabelAccuracyEvaluator.softmax_head_classifier(enc, w, np.ones(3)))
    assert got == jeval.LabelAccuracyEvaluator(s1, s2, labels)(
        jeval.LabelAccuracyEvaluator.softmax_head_classifier(enc, w, np.ones(3)))


def write_useb(root, rng, n=24):
    """The four USEB tasks' folders under `root`, in the formats of
    tests/test_useb.py's fixtures, with random word texts (some repeated)."""
    import json as _json

    def text(lo=2, hi=9):
        return " ".join(f"w{rng.integers(0, 30)}" for _ in range(int(rng.integers(lo, hi))))

    d = root / "askubuntu"
    d.mkdir(parents=True)
    with open(d / "text_tokenized.txt", "w") as f:
        for i in range(n):
            f.write(f"q{i}\t{text()}\t{text()}\n")
    for fname in ("test.txt", "dev.txt"):
        with open(d / fname, "w") as f:
            for i in range(n // 3):
                cands = rng.choice(n, 6, replace=False)
                scores = " ".join(f"{x:.2f}" for x in rng.random(6))
                gold = " ".join(f"q{c}" for c in cands[:2])
                f.write(f"q{i}\t{gold}\t{' '.join(f'q{c}' for c in cands)}\t{scores}\n")
    d = root / "cqadupstack"
    d.mkdir()
    corpus = {forum: {f"d{i}": text() for i in range(n)} for forum in ("android", "gis")}
    split = {s: {forum: {f"d{i}": [f"d{i + 1}", f"d{i + 5}"] for i in range(0, n - 5, 4)}
                 for forum in corpus} for s in ("test", "valid")}
    (d / "corpus.json").write_text(_json.dumps(corpus))
    (d / "retrieval_split.json").write_text(_json.dumps(split))
    d = root / "twitterpara"
    d.mkdir()
    with open(d / "Twitter_URL_Corpus_test.txt", "w") as f:
        for i in range(n):
            f.write(f"{text()}\t{text()}\t({int(rng.integers(0, 7))}, 6)\n")
    with open(d / "test.data", "w") as f:
        for i in range(n):
            f.write(f"id\ttopic\t{text()}\t{text()}\t{int(rng.integers(0, 6))}\n")
    d = root / "scidocs"
    d.mkdir()
    papers = {f"p{i}": {"title": None if i == 3 else ("" if i == 4 else text())}
              for i in range(n)}
    data = {"corpus": papers}
    for s in ("test", "valid"):
        data[s] = {task: {f"p{q}": {f"p{int(c)}": int(rng.integers(0, 2))
                                    for c in rng.choice(n, 5, replace=False)}
                          for q in range(0, n, 6)}
                   for task in ("cite", "cocite", "coview", "coread")}
    (d / "data.json").write_text(_json.dumps(data))


def test_useb_evaluators_match(tmp_path):
    from sgpt_tpu.evaluation import useb as juseb
    from sgpt_tpu_torch.evaluation import useb as puseb

    write_useb(tmp_path, np.random.default_rng(8))
    enc = _table_encoder(dim=6)
    assert list(puseb.EVALUATORS) == list(juseb.EVALUATORS)
    for eval_type in ("test", "valid"):
        for name in puseb.EVALUATORS:
            got = puseb.run_on(name, enc, eval_type, str(tmp_path))
            assert got == juseb.run_on(name, enc, eval_type, str(tmp_path)) and got, name
    fns = {name: enc for name in ("askubuntu", "scidocs", "twitterpara")}
    got = puseb.run(fns, data_eval_path=str(tmp_path), normalize=False,
                    output_dir=str(tmp_path / "p"))
    assert got == juseb.run(fns, data_eval_path=str(tmp_path), normalize=False,
                            output_dir=str(tmp_path / "j"))
    for f in ("results.detailed.json", "results.average_precision.json"):
        assert (tmp_path / "p" / f).read_text() == (tmp_path / "j" / f).read_text()
    assert (puseb._sklearn_ap([1, 0, 1, 0], [0.3, 0.9, 0.2, 0.2])
            == juseb._sklearn_ap([1, 0, 1, 0], [0.3, 0.9, 0.2, 0.2]))
