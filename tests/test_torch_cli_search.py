"""The port's search CLIs on the CPU.

`beir_retriever` on a synthetic BEIR folder, with `build_model` patched to a
tiny GPT-Neo whose weights the JAX CLI (patched the same way) also gets: the
two write results files with the same documents per query, in the same
order, scores within 1e-5, and equal nDCG/MAP/recall/precision entries in
`beir_embeddings_ndcgs.json`. `serve`: the flags that are not ported raise
before anything is built; a server built from flags (int8 corpus, a jsonl
corpus, a persisted index) answers over HTTP.
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
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.cli import beir_retriever, serve  # noqa: E402
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


def test_beir_retriever_matches_jax_cli(tmp_path, monkeypatch):
    _write_beir(tmp_path / "data" / "synth")
    common = ["--modelname", "tiny/neo", "--dataset", "synth",
              "--datapath", str(tmp_path / "data"), "--specb", "--maxseqlen", "64",
              "--batchsize", "4", "--randominit", "--dtype", "float32"]
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


@pytest.mark.parametrize("flags,match", [(["--quantize", "int8"], "item 9"),
                                         (["--layeridx", "3"], "item 5")])
def test_beir_retriever_refuses_what_is_not_ported(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        beir_retriever.main(beir_retriever.parse_args(["--randominit", *flags]))


@pytest.mark.parametrize("flags,match", [
    (["--index", "ivf"], "item 13"), (["--rerank"], "item 8"),
    (["--rerank-model", "gpt2"], "item 8"), (["--quantize", "int8"], "item 9")])
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
