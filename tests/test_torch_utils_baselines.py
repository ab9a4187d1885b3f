"""The port's `utils/` and `baselines/` == the JAX package's, offline.

Every case of `tests/test_utils_baselines.py` (the parallelizer, io_utils,
profiling, the OpenAI retriever and search scoring with fake clients) and of
`tests/test_openai_client.py` (the HTTP client, the BEIR and USEB fetches,
the zip-slip guard) runs through both packages: the same checks on the
port's output, and the two outputs equal. One local fake HTTP server on
127.0.0.1 serves both. Beside them: `Timer`'s synchronise and its device
errors, `profile_trace`'s Chrome trace, the wandb logger (absent, and a
fake module), and `useb_retriever --download` (an existing `--datapath` is
read with no fetch; a missing one is fetched from the fake server).
"""
import hashlib
import io
import json
import os
import sys
import threading
import time
import types
import urllib.request
import zipfile
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX package's utils import jax: keep it on the CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import sgpt_tpu.baselines as jbase  # noqa: E402
import sgpt_tpu.utils as jutils  # noqa: E402
import sgpt_tpu_torch.baselines as pbase  # noqa: E402
import sgpt_tpu_torch.utils as putils  # noqa: E402
from sgpt_tpu.baselines import openai_client as jclient  # noqa: E402
from sgpt_tpu.utils import wandb_logger as jwandb  # noqa: E402
from sgpt_tpu_torch.baselines import openai_client as pclient  # noqa: E402
from sgpt_tpu_torch.utils import profiling as pprofiling  # noqa: E402
from sgpt_tpu_torch.utils import wandb_logger as pwandb  # noqa: E402

BOTH = (("port", putils, pbase, pclient), ("jax", jutils, jbase, jclient))


def _useb_askubuntu(rng, n=12) -> dict:
    """The USEB AskUbuntu task in its on-disk format (tests/test_useb.py's
    fixtures): {relative path: text}."""
    def text():
        return " ".join(f"w{rng.integers(0, 40)}" for _ in range(int(rng.integers(2, 9))))

    rows = []
    for i in range(n // 3):
        cands = rng.choice(n, 6, replace=False)
        rows.append(f"q{i}\tq{cands[0]} q{cands[1]}\t{' '.join(f'q{c}' for c in cands)}\t"
                    + " ".join(f"{x:.2f}" for x in rng.random(6)) + "\n")
    return {"askubuntu/text_tokenized.txt": "".join(f"q{i}\t{text()}\t{text()}\n"
                                                     for i in range(n)),
            "askubuntu/test.txt": "".join(rows), "askubuntu/dev.txt": "".join(rows)}


USEB_FILES = _useb_askubuntu(np.random.default_rng(4))


class _FakeAPI(BaseHTTPRequestHandler):
    """tests/test_openai_client.py's fake: embeddings with vector[0] =
    len(text) and vector[1] = the model's id, rows REVERSED (the client
    orders them by index); zips of a BEIR dataset, of the USEB data (the
    eval archive holds a readable AskUbuntu task) and a zip-slip archive."""

    models = {"q-model": 1.0, "d-model": 2.0, "text-embedding-3-small": 3.0}

    def do_POST(self):
        if self.headers.get("Authorization") != "Bearer test-key":
            self.send_response(401)
            self.end_headers()
            return
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        rows = [{"index": i, "embedding": [float(len(t)), self.models[body["model"]], 0.0]}
                for i, t in enumerate(body["input"])]
        out = json.dumps({"data": list(reversed(rows))}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.end_headers()
        self.wfile.write(out)

    def do_GET(self):
        buf = io.BytesIO()
        if self.path.endswith("toy.zip"):
            with zipfile.ZipFile(buf, "w") as z:
                z.writestr("toy/corpus.jsonl", json.dumps({"_id": "d0", "title": "", "text": "x"}))
                z.writestr("toy/queries.jsonl", json.dumps({"_id": "q0", "text": "x"}))
                z.writestr("toy/qrels/test.tsv", "query-id\tcorpus-id\tscore\n")
        elif self.path.endswith("data-eval.zip"):
            with zipfile.ZipFile(buf, "w") as z:
                for name, text in USEB_FILES.items():
                    z.writestr(f"data/eval/{name}", text)
        elif self.path.endswith("data-train.zip"):
            with zipfile.ZipFile(buf, "w") as z:
                z.writestr("data/train/askubuntu/train.txt", "q\n")
        elif self.path.endswith("evil.zip"):
            with zipfile.ZipFile(buf, "w") as z:
                z.writestr("../escape.txt", "zip-slip")
        else:
            self.send_response(404)
            self.end_headers()
            return
        data = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def server():
    srv = HTTPServer(("127.0.0.1", 0), _FakeAPI)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def _tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_both_packages_export_the_same_names():
    """The port's utils are the JAX package's less `ThroughputMeter` (a rate
    is items over `Timer.elapsed`) plus `span`, the program's profiler
    ranges."""
    assert set(putils.__all__) == set(jutils.__all__) - {"ThroughputMeter"} | {"span"}
    assert set(pbase.__all__) == set(jbase.__all__)
    assert pclient.DEFAULT_BASE_URL == jclient.DEFAULT_BASE_URL
    assert pclient.USEB_DATA_URL == jclient.USEB_DATA_URL
    assert pclient.BEIR_DATASET_URL == jclient.BEIR_DATASET_URL


# -- tests/test_utils_baselines.py's cases -----------------------------------------

def test_parallelizer_row_mode_preserves_order():
    def fn(row):
        time.sleep(0.001 * (5 - row["i"] % 5))
        return row["i"] * 2

    rows = [{"i": i} for i in range(20)]
    outs = [u.DataFrameParallelizer(fn, parallel_workers=8).run(rows) for _, u, _, _ in BOTH]
    assert [r["output_response"] for r in outs[0]] == [i * 2 for i in range(20)]
    assert outs[0] == outs[1]


def test_parallelizer_batch_mode_and_errors():
    def fn(batch):
        if batch[0]["i"] == 0:
            raise ValueError("boom")
        return [r["i"] for r in batch]

    rows = [{"i": i} for i in range(6)]
    outs = [u.DataFrameParallelizer(fn, batch_support=True, batch_size=2,
                                    error_handling=u.ErrorHandling.LOG).run(rows)
            for _, u, _, _ in BOTH]
    assert outs[0][0]["output_error_type"] == "ValueError"
    assert outs[0][2]["output_response"] == 2
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pkg", [b[0] for b in BOTH])
def test_parallelizer_fail_mode_raises(pkg):
    u = dict((b[0], b[1]) for b in BOTH)[pkg]

    def fn(row):
        raise RuntimeError("nope")

    with pytest.raises(RuntimeError, match="nope"):
        u.DataFrameParallelizer(fn, error_handling=u.ErrorHandling.FAIL).run([{"a": 1}])


def test_parallelizer_pandas_roundtrip():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame({"x": [1, 2, 3]})
    outs = [u.DataFrameParallelizer(lambda r: r["x"] + 1).run(df) for _, u, _, _ in BOTH]
    assert list(outs[0]["output_response"]) == [2, 3, 4]
    pd.testing.assert_frame_equal(outs[0], outs[1])


def test_retry_decorator():
    for _, u, _, _ in BOTH:
        calls = []

        @u.retry(tries=3, delay=0.01)
        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise IOError("transient")
            return "ok"

        assert flaky() == "ok" and len(calls) == 3


def test_io_utils():
    for _, u, _, _ in BOTH:
        assert u.unique_list([3, 1, 3, 2, 1]) == [3, 1, 2]
        assert u.truncate_text_list(["x" * 200])[0].endswith("(...)")
        assert u.generate_unique("a", ["a", "a_2"]) == "a_3"
        assert u.generate_unique("b", ["a"], prefix="p") == "p_b"
        assert u.clean_empty_list([]) == "" and u.clean_empty_list(None) == ""


def test_profiling_utils():
    with putils.Timer(sync=False) as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01


def test_openai_retriever_fake_client(tmp_path):
    outs = []
    for name, _, b, _ in BOTH:
        calls = []

        def embed_fn(texts, is_query):
            calls.append(len(texts))
            return [[sum(map(ord, t)) % 7, 1.0 if is_query else 2.0] for t in texts]

        r = b.OpenAIRetriever(embed_fn, batch_size=2, cache_dir=str(tmp_path / name))
        q = r.encode_queries(["alpha", "beta", "gamma"])
        assert q.shape == (3, 2)
        c = r.encode_corpus([{"title": "T", "text": "doc"}])
        assert c.shape == (1, 2)
        n = len(calls)
        np.testing.assert_array_equal(r.encode_queries(["alpha", "beta", "gamma"]), q)
        assert len(calls) == n   # a cache hit makes no call
        outs.append((q, c, sorted(calls)))
    for a, b in zip(*outs[:2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax")


def test_openai_retriever_retries_then_fails():
    for _, _, b, _ in BOTH:
        attempts = []

        def embed_fn(texts, is_query):
            attempts.append(1)
            raise IOError("down")

        r = b.OpenAIRetriever(embed_fn, batch_size=10, retries=2)
        with pytest.raises(RuntimeError, match="1 embedding rows failed"):
            r.encode_queries(["q"])
        assert len(attempts) == 2


def test_openai_search_scoring():
    def complete_fn(prompts):   # uniform logprob -1 per token, offsets by character
        out = []
        for p in prompts:
            toks = p.split(" ")
            offsets, pos = [], 0
            for t in toks:
                offsets.append(pos)
                pos += len(t) + 1
            out.append({"token_logprobs": [-1.0] * len(toks), "text_offset": offsets})
        return out

    res = [b.openai_search("the query", ["docA", "docB"], complete_fn) for _, _, b, _ in BOTH]
    assert [r["document"] for r in res[0]] == [0, 1]
    assert all(isinstance(r["score"], float) for r in res[0])
    assert res[0] == res[1]


# -- tests/test_openai_client.py's cases -------------------------------------------

def test_client_requires_key(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for _, _, b, _ in BOTH:
        with pytest.raises(ValueError, match="default-off"):
            b.OpenAIEmbedClient()


def test_client_embeds_and_reorders(server):
    outs = [b.OpenAIEmbedClient(api_key="test-key", base_url=server)(["a", "bbb", "cc"],
                                                                     is_query=False)
            for _, _, b, _ in BOTH]
    assert [v[0] for v in outs[0]] == [1.0, 3.0, 2.0]   # the index order, not the reply's
    assert all(v[1] == 3.0 for v in outs[0])            # the default symmetric model
    assert outs[0] == outs[1]


def test_client_query_doc_model_split(server, monkeypatch):
    monkeypatch.setenv("OPENAI_API_KEY", "test-key")   # the key from the environment
    for _, _, b, _ in BOTH:
        client = b.OpenAIEmbedClient(base_url=server + "/", query_model="q-model",
                                     doc_model="d-model")
        assert client(["x"], is_query=True)[0][1] == 1.0
        assert client(["x"], is_query=False)[0][1] == 2.0


def test_client_plugs_into_retriever(server, tmp_path):
    """The client IS the retriever's embed_fn: batching, fan-out and the
    cache apply unchanged."""
    corpus = [{"title": "", "text": t} for t in ("one", "two words", "three")]
    outs = []
    for name, _, b, _ in BOTH:
        r = b.OpenAIRetriever(b.OpenAIEmbedClient(api_key="test-key", base_url=server),
                              batch_size=2, parallel_workers=2,
                              cache_dir=str(tmp_path / name / "cache"))
        emb = r.encode_corpus(corpus)
        assert emb.shape == (3, 3)
        np.testing.assert_allclose(emb[:, 0], [len("one"), len("two words"), len("three")])
        np.testing.assert_array_equal(r.encode_corpus(corpus), emb)
        outs.append(emb)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_client_refuses_a_short_reply(server, monkeypatch):
    """A reply with fewer rows than inputs raises, on both sides."""
    for _, _, _, c in BOTH:
        client = c.OpenAIEmbedClient(api_key="test-key", base_url=server)
        real = c.urllib.request.urlopen

        def short(req, timeout):
            resp = real(req, timeout=timeout)
            body = json.loads(resp.read())
            body["data"] = body["data"][:1]
            return io.BytesIO(json.dumps(body).encode())

        monkeypatch.setattr(c.urllib.request, "urlopen", short)
        with pytest.raises(RuntimeError, match="returned 1 rows for 2"):
            client(["a", "b"], is_query=True)
        monkeypatch.undo()


def test_fetch_beir_dataset(server, tmp_path):
    trees = []
    for name, _, b, _ in BOTH:
        out = b.fetch_beir_dataset("toy", out_dir=str(tmp_path / name), base_url=server)
        assert os.path.isfile(os.path.join(out, "corpus.jsonl"))
        # a second call finds the folder and fetches nothing
        assert b.fetch_beir_dataset("toy", out_dir=str(tmp_path / name),
                                    base_url="http://127.0.0.1:9") == out
        trees.append(_tree(tmp_path / name))
    assert trees[0] == trees[1] and "toy/qrels/test.tsv" in trees[0]


def test_fetch_beir_dataset_clear_error(tmp_path):
    for name, _, b, _ in BOTH:
        with pytest.raises(RuntimeError, match="zero-egress"):
            b.fetch_beir_dataset("nope", out_dir=str(tmp_path / name),
                                 base_url="http://127.0.0.1:9")   # a closed port
        assert os.listdir(tmp_path / name) == []


def test_fetch_beir_dataset_checksum_ok_and_mismatch(server, tmp_path):
    with urllib.request.urlopen(f"{server}/toy.zip") as r:
        good = hashlib.sha256(r.read()).hexdigest()
    for name, _, _, c in BOTH:
        out = c.fetch_beir_dataset("toy", out_dir=str(tmp_path / name / "a"), base_url=server,
                                   sha256=good)
        assert os.path.exists(os.path.join(out, "corpus.jsonl"))
        with pytest.raises(RuntimeError, match="checksum mismatch"):
            c.fetch_beir_dataset("toy", out_dir=str(tmp_path / name / "b"), base_url=server,
                                 sha256="0" * 64)
        assert os.listdir(tmp_path / name / "b") == []   # no _part, no zip


def test_fetch_useb_data(server, tmp_path):
    trees = []
    for name, _, _, c in BOTH:
        dirs = c.fetch_useb_data("all", out_dir=str(tmp_path / name), base_url=server)
        assert [os.path.basename(d) for d in dirs] == ["train", "eval"]
        assert os.path.exists(tmp_path / name / "data" / "eval" / "askubuntu" / "test.txt")
        again = c.fetch_useb_data("eval", out_dir=str(tmp_path / name),
                                  base_url="http://127.0.0.1:9")   # on disk: no request
        assert [os.path.basename(d) for d in again] == ["eval"]
        trees.append(_tree(tmp_path / name))
    assert trees[0] == trees[1]


def test_fetch_useb_data_validates_selector(tmp_path):
    for _, _, _, c in BOTH:
        with pytest.raises(ValueError, match="which"):
            c.fetch_useb_data("dev", out_dir=str(tmp_path))


def test_zip_slip_rejected(server, tmp_path):
    for name, _, _, c in BOTH:
        zp = str(tmp_path / f"{name}-evil.zip")
        c._http_download(f"{server}/evil.zip", zp)
        with pytest.raises(RuntimeError, match="escapes"):
            c._safe_extract(zp, str(tmp_path / name / "out"))
        assert not os.path.exists(tmp_path / name / "escape.txt")
        assert not os.path.exists(tmp_path / "escape.txt")


# -- profiling: the synchronise, device errors, the trace -------------------------

def test_timer_synchronises_an_initialised_card_and_raises_its_errors(monkeypatch):
    """Timer synchronises the current CUDA device where CUDA is initialised
    (and not where it is not, nor with sync=False); an error of the
    synchronise (a device fault on the card) propagates."""
    calls = []
    monkeypatch.setattr(pprofiling.torch.cuda, "synchronize", lambda: calls.append(1))
    monkeypatch.setattr(pprofiling.torch.cuda, "is_initialized", lambda: False)
    with putils.Timer():
        pass
    assert calls == []
    monkeypatch.setattr(pprofiling.torch.cuda, "is_initialized", lambda: True)
    with putils.Timer(sync=False):
        pass
    assert calls == []
    with putils.Timer() as t:
        pass
    assert calls == [1] and t.elapsed >= 0

    def fault():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(pprofiling.torch.cuda, "synchronize", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with putils.Timer():
            pass


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """profile_trace(logdir) writes one Chrome trace of the block's ops into
    logdir (CPU activities here); a falsy logdir profiles nothing."""
    with putils.profile_trace(None):
        torch.ones(4).sum()
    with putils.profile_trace(""):
        pass
    logdir = tmp_path / "trace"
    with putils.profile_trace(str(logdir)):
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::mm" in names


# -- the wandb logger ----------------------------------------------------------------

def test_wandb_logger_absent_and_with_a_fake_module(monkeypatch):
    """No wandb installed: None, on both sides. A fake `wandb` module: the
    same init arguments and logged records on both sides."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert pwandb.make_wandb_log_fn("p") is None and jwandb.make_wandb_log_fn("p") is None
    seen = {}
    for name, mod in (("port", pwandb), ("jax", jwandb)):
        log = []

        class Run:
            def log(self, payload, step=None):
                log.append((payload, step))

        fake = types.SimpleNamespace(
            init=lambda project, config, name, log=log: log.append((project, config, name))
            or Run())
        monkeypatch.setitem(sys.modules, "wandb", fake)
        fn = mod.make_wandb_log_fn("proj", config={"lr": 1e-4}, name="run")
        fn({"step": 3, "loss": 0.5})
        fn({"loss": 0.25})
        seen[name] = log
    assert seen["port"] == seen["jax"] == [
        ("proj", {"lr": 1e-4}, "run"), ({"loss": 0.5}, 3), ({"loss": 0.25}, None)]


# -- useb_retriever --download -------------------------------------------------------

def _tiny_build(model_name, random_init=False, dtype_str="float32", device="cpu", seed=0):
    from sgpt_tpu_torch.models import Decoder, tiny
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    cfg = tiny("neo", num_layers=1, hidden_size=32, num_heads=2, vocab_size=128)
    return (Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0)), cfg,
            SimpleTokenizer(vocab_size=128))


def _useb(tmp_path, monkeypatch, datapath, *flags):
    from sgpt_tpu_torch.cli import useb_retriever

    monkeypatch.setattr(useb_retriever, "build_model", _tiny_build)
    out = tmp_path / f"out{len(list(tmp_path.glob('out*.json')))}.json"
    useb_retriever.main(useb_retriever.parse_args(
        ["--randominit", "--device", "cpu", "--tasks", "askubuntu", "--maxseqlen", "32",
         "--datapath", str(datapath), "--output", str(out), *flags]))
    return json.loads(out.read_text())


def test_useb_download_reads_an_existing_datapath(tmp_path, monkeypatch):
    """An existing --datapath is read as it is: no fetch (the archive URL is
    a closed port, and the fetch itself would raise)."""
    data = tmp_path / "useb"
    for name, text in USEB_FILES.items():
        (data / name).parent.mkdir(parents=True, exist_ok=True)
        (data / name).write_text(text)

    def no_fetch(*a, **kw):
        raise AssertionError("fetched although --datapath exists")

    monkeypatch.setattr(pbase, "fetch_useb_data", no_fetch)
    monkeypatch.setattr(pclient, "USEB_DATA_URL", "http://127.0.0.1:9")
    got = _useb(tmp_path, monkeypatch, data, "--download")
    assert got == _useb(tmp_path, monkeypatch, data)
    assert list(got["main"]) == ["askubuntu", "avg"] and np.isfinite(got["main"]["avg"])


def test_useb_download_fetches_a_missing_datapath(tmp_path, monkeypatch, server):
    """A missing --datapath: the eval archive comes from USEB_DATA_URL (the
    fake server here) into the working directory, and data/eval is read —
    the same scores as reading the archive's files directly."""
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr(pclient, "USEB_DATA_URL", server)
    got = _useb(tmp_path, monkeypatch, work / "missing", "--download")
    assert _tree(work / "data" / "eval") == {k: v.encode() for k, v in USEB_FILES.items()}
    assert got == _useb(tmp_path, monkeypatch, work / "data" / "eval")
    assert not (work / "data-eval.zip").exists()
