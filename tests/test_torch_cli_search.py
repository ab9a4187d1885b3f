"""The port's search and rerank CLIs on the CPU.

`beir_retriever` on a synthetic BEIR folder, with `build_model` patched to a
tiny GPT-Neo whose weights the JAX CLI (patched the same way) also gets: the
two write results files with the same documents per query, in the same
order, scores within 1e-5, and equal nDCG/MAP/recall/precision entries in
`beir_embeddings_ndcgs.json`, also with `--layeridx`. `bm25_retriever` writes the JAX CLI's
first-stage json, and `sgptce` reranks it into the JAX CLI's result json
(metrics within 1e-6; the CE scores agree to ~1e-6). `serve`: the flags
that are not ported raise before anything is built; a server built from
flags (int8 corpus, a jsonl corpus, a persisted index, `--rerank` and
`--rerank-model`) answers over HTTP.
"""
import http.client
import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from sgpt_tpu.cli import beir_retriever as jax_beir  # noqa: E402
from sgpt_tpu.cli import bm25_retriever as jax_bm25  # noqa: E402
from sgpt_tpu.cli import sgptce as jax_sgptce  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.cli import beir_retriever, bm25_retriever, serve, sgptce  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402

JCFG = jax_tiny("neo", num_layers=2)
JPARAMS = jax_init_params(JCFG, jax.random.key(0))


def _jax_build(model_name, random_init=False, dtype_str="bfloat16"):
    return JPARAMS, JCFG, SimpleTokenizer(vocab_size=JCFG.vocab_size)


def _port_build(model_name, random_init=False, dtype_str="float32", device="cpu", seed=0):
    cfg = from_jax_config(JCFG)
    model = Decoder(cfg, device=device)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, JPARAMS), cfg))
    return model, cfg, SimpleTokenizer(vocab_size=cfg.vocab_size)


def _write_beir(root, n_docs=40, n_queries=8, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]
    docs = [" ".join(rng.choice(words, size=int(rng.integers(4, 40)))) for _ in range(n_docs)]
    (root / "qrels").mkdir(parents=True)
    with open(root / "corpus.jsonl", "w") as f:
        for i, t in enumerate(docs):
            f.write(json.dumps({"_id": f"d{i}", "title": "t" if i % 5 == 0 else "",
                                "text": t}) + "\n")
    with open(root / "queries.jsonl", "w") as f:
        for i in range(n_queries):
            f.write(json.dumps({"_id": f"q{i}", "text": docs[i * 3]}) + "\n")
    with open(root / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for i in range(n_queries):
            f.write(f"q{i}\td{i * 3}\t1\n")
            f.write(f"q{i}\td{i * 3 + 1}\t1\n")


def _beir_parity(tmp_path, monkeypatch, extra=()):
    """Both CLIs on one synthetic BEIR folder with `extra` flags: the same
    documents per query, scores within 1e-5, equal metric entries."""
    _write_beir(tmp_path / "data" / "synth")
    common = ["--modelname", "tiny/neo", "--dataset", "synth",
              "--datapath", str(tmp_path / "data"), "--specb", "--maxseqlen", "64",
              "--batchsize", "4", "--randominit", "--dtype", "float32", *extra]
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(jax_beir, "build_model", _jax_build)
    monkeypatch.setattr(sys, "argv", ["x", *common, "--dp", "1", "--tp", "1"])
    jax_beir.main()

    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(beir_retriever, "build_model", _port_build)
    ndcg = beir_retriever.main(beir_retriever.parse_args([*common, "--device", "cpu"]))
    assert ndcg["NDCG@10"] > 0

    name = "results_tiny_neo_weightedmean_synth.json"
    want = json.loads((tmp_path / "jax" / name).read_text())
    got = json.loads((tmp_path / "port" / name).read_text())
    assert list(got) == list(want)
    for qid in want:
        assert list(got[qid]) == list(want[qid]), qid
        np.testing.assert_allclose(list(got[qid].values()), list(want[qid].values()),
                                   atol=1e-5)
    store = "beir_embeddings_ndcgs.json"
    assert json.loads((tmp_path / "port" / store).read_text()) == \
        json.loads((tmp_path / "jax" / store).read_text())


def test_beir_retriever_matches_jax_cli(tmp_path, monkeypatch):
    _beir_parity(tmp_path, monkeypatch)


def test_beir_retriever_layeridx_matches_jax_cli(tmp_path, monkeypatch):
    """`--layeridx 1` (of 2 layers) pools a middle layer's states on both sides."""
    _beir_parity(tmp_path, monkeypatch, ["--layeridx", "1"])


@pytest.mark.parametrize("flags,match", [(["--quantize", "int8"], "item 9")])
def test_beir_retriever_refuses_what_is_not_ported(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        beir_retriever.main(beir_retriever.parse_args(["--randominit", *flags]))


def _run_jax_cli(module, argv, cwd, monkeypatch):
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", ["x", *argv])
    return module.main()


def test_bm25_retriever_matches_jax_cli(tmp_path, monkeypatch):
    _write_beir(tmp_path / "data" / "synth")
    common = ["--dataset", "synth", "--datadir", str(tmp_path / "data"), "--topk", "7"]
    _run_jax_cli(jax_bm25, common, tmp_path / "jax", monkeypatch)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    ndcg = bm25_retriever.main(bm25_retriever.parse_args(common))
    assert ndcg["NDCG@5"] > 0
    want = json.loads((tmp_path / "jax" / "results_synth.json").read_text())
    assert json.loads((tmp_path / "port" / "results_synth.json").read_text()) == want
    assert all(len(hits) == 7 for hits in want.values())
    # an existing result is kept unless --overwrite
    assert bm25_retriever.main(bm25_retriever.parse_args(common)) is None


@pytest.mark.parametrize("flags", [["--prompt", "G"], ["--prompt", "A,L", "--packt", "64"],
                                   ["--prompt", "K", "--fewshot"]])
def test_sgptce_matches_jax_cli(tmp_path, monkeypatch, flags):
    """BM25 first stage, then the rerank on the same first-stage json."""
    _write_beir(tmp_path / "data" / "synth")
    first = tmp_path / "bm25.json"
    bm25_retriever.main(bm25_retriever.parse_args([
        "--dataset", "synth", "--datadir", str(tmp_path / "data"), "--topk", "10",
        "--output", str(first)]))
    common = ["--dataset", "synth", "--datadir", str(tmp_path / "data"), "--modelpath",
              "tiny/neo", "--bm25results", str(first), "--randominit", "--dtype", "float32",
              "--batchsize", "4", "--topk", "5", "--maxseqlen", "128", *flags]
    monkeypatch.setattr(jax_sgptce, "build_model", _jax_build)
    _run_jax_cli(jax_sgptce, common, tmp_path / "jax", monkeypatch)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(sgptce, "build_model", _port_build)
    outs = sgptce.main(sgptce.parse_args([*common, "--device", "cpu"]))
    assert list(outs) == flags[1].split(",")
    for pid, path in outs.items():
        got = json.loads((tmp_path / "port" / path).read_text())
        want = json.loads((tmp_path / "jax" / path).read_text())
        assert got["prompt"] == pid and got["fewshot"] == ("--fewshot" in flags)
        assert {k: got[k] for k in ("dataset", "model", "prompt", "fewshot", "bm25_ndcg")} == \
            {k: want[k] for k in ("dataset", "model", "prompt", "fewshot", "bm25_ndcg")}
        for key in ("ce_ndcg", "ce_map", "ce_recall", "ce_precision"):
            assert list(got[key]) == list(want[key])
            np.testing.assert_allclose(list(got[key].values()), list(want[key].values()),
                                       atol=1e-6, err_msg=key)
    store = "sgptce_ndcgs.json"
    assert list(json.loads((tmp_path / "port" / store).read_text())["ndcgs"]) == \
        list(json.loads((tmp_path / "jax" / store).read_text())["ndcgs"])


@pytest.mark.parametrize("flags,exc", [(["--prompt", "G,nope"], SystemExit),
                                       (["--prompt", "J"], SystemExit),
                                       (["--quantize", "int8"], NotImplementedError)])
def test_sgptce_refuses_before_loading(flags, exc, tmp_path):
    with pytest.raises(exc):
        sgptce.main(sgptce.parse_args(["--datadir", str(tmp_path), "--randominit", *flags]))


@pytest.mark.parametrize("flags,match", [
    (["--index", "ivf"], "item 13"), (["--quantize", "int8"], "item 9")])
def test_serve_refuses_what_is_not_ported(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        serve.main(["--modelname", "gpt-neo-125m", "--randominit", *flags])


def test_serve_parses_the_jax_flags():
    args = serve.parse_args(["--modelname", "m", "--quantize-index", "int8", "--clusters",
                             "64", "--nprobe", "8", "--max-wait-ms", "2", "--no-warmup",
                             "--allow-save-path", "--device", "cpu"])
    assert (args.quantize_index, args.clusters, args.nprobe, args.max_wait_ms) == \
        ("int8", 64, 8, 2.0)
    assert args.no_warmup and args.allow_save_path and args.device == "cpu"
    assert serve.parse_args(["--modelname", "m"]).clusters == "auto"
    with pytest.raises(SystemExit):
        serve.parse_args(["--modelname", "m", "--dp", "2"])


def _post(server, path, payload):
    conn = http.client.HTTPConnection(*server.server_address[:2], timeout=30)
    try:
        conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        conn.close()


def test_serve_builds_a_server_from_flags(tmp_path, monkeypatch):
    """--corpus (the JAX loader's rows: `_id`+title, bare `id`, no id),
    --quantize-index int8, --index-path saved after the first build and
    loaded by the next server."""
    monkeypatch.setattr(serve, "build_model", _port_build)
    corpus = tmp_path / "corpus.jsonl"
    corpus.write_text('{"_id": "a", "title": "T", "text": "body one about rivers"}\n'
                      '{"id": "b", "text": "body two about mountains"}\n'
                      '{"text": "no id at all, about deserts"}\n')
    assert serve.load_jsonl_corpus(str(corpus)) == (
        ["a", "b", "2"], ["T body one about rivers", "body two about mountains",
                          "no id at all, about deserts"])
    flags = ["--modelname", "tiny", "--randominit", "--device", "cpu", "--port", "0",
             "--maxseqlen", "64", "--batchsize", "4", "--quantize-index", "int8",
             "--index-path", str(tmp_path / "idx")]
    answers = []
    for extra in (["--corpus", str(corpus)], []):
        server, service = serve.build_server(serve.parse_args(flags + extra))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            assert service.index.quantize == "int8" and len(service.index) == 3
            status, body = _post(server, "/search", {"queries": ["body two about mountains"],
                                                     "k": 3, "return_documents": True})
            assert status == 200
            answers.append(body["results"][0])
        finally:
            server.shutdown()
            server.server_close()
            service.close()
    assert (tmp_path / "idx" / "index.npz").exists()
    assert answers[0] == answers[1] and answers[0][0]["id"] == "b"
    assert answers[0][0]["document"] == "body two about mountains"


@pytest.mark.parametrize("rerank", [["--rerank"], ["--rerank-model", "tiny-ce"]])
def test_serve_rerank_answers(tmp_path, monkeypatch, rerank):
    """--rerank (the encoder's model) and --rerank-model (a second model):
    POST /rerank answers what service.rerank gives directly."""
    models = []

    def build(*a, **kw):
        models.append(_port_build(*a, **kw))
        return models[-1]

    monkeypatch.setattr(serve, "build_model", build)
    corpus = tmp_path / "corpus.jsonl"
    corpus.write_text("".join(json.dumps({"_id": f"d{i}", "text": t}) + "\n" for i, t in
                              enumerate(["rivers run to the sea", "mountains are tall",
                                         "the sea is salty", "deserts are dry"])))
    server, service = serve.build_server(serve.parse_args([
        "--modelname", "tiny", "--randominit", "--device", "cpu", "--port", "0",
        "--maxseqlen", "64", "--batchsize", "4", "--corpus", str(corpus),
        "--rerank-maxlen", "64", "--rerank-pack-t", "64", "--rerank-prompt", "G", *rerank]))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        assert len(models) == 1 + ("--rerank-model" in rerank)
        assert service.ranker.model is models[-1][0] and service.ranker.pack_t == 64
        query = {"queries": ["the salty sea", "tall mountains"], "k": 2, "first_k": 4}
        status, body = _post(server, "/rerank", query)
        assert status == 200
        want = service.rerank(query["queries"], k=2, first_k=4)
        assert body["results"] == want
        assert all(len(r) == 2 and {"id", "score", "ce_score"} <= set(r[0]) for r in want)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
