"""Each cell's run driven on the CPU at a tiny width: the result line's
schema, the reference check passing on the program as it is, and failing
on a program broken underneath (an answer altered where it is produced) and
on the control (the program's int8 path). A new configuration, mix, cell and
metric are found as new files."""
from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest

from benchmark import control, harness

from .conftest import tiny_spec

CELLS = ["encode.sgpt-5.8b.beir-docs", "encode.sgpt-bloom-7b1.beir-docs",
         "rerank.sgpt-5.8b.bm25-top100", "search.sgpt-5.8b.nq-poisson"]
SEED = 3_000_000_017   # more than 32 signed bits hold


def _run(manifest, cell, trace=False, spec=None, root=harness.ROOT):
    spec = spec or tiny_spec(cell, root)
    return harness.run_cell(manifest, cell, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                            root=root, spec=spec)


def _schema(out, manifest, cell, trace):
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    want = {n: u for n, u in harness.metrics_of(manifest, cell, trace)}
    for name, m in out["metrics"].items():
        assert m["unit"] == want[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
    else:
        assert set(out["metrics"]) == set(want)
    json.loads(json.dumps(out, allow_nan=False))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_checks_correct(manifest, cell):
    for trace in (False, True):
        out = _run(manifest, cell, trace)
        _schema(out, manifest, cell, trace)
        assert out["correct"], out["checks"]
        assert out["failed"] == 0 and out["attempted"] > 0


def _alter_embeddings(monkeypatch):
    from sgpt_tpu_torch.encoder import EmbeddingEngine

    orig = EmbeddingEngine.encode

    def encode(self, texts, **kw):
        out = orig(self, texts, **kw)
        out[::2] = out[::2][:, ::-1]       # half the answers altered
        return out
    monkeypatch.setattr(EmbeddingEngine, "encode", encode)


def _alter_scores(monkeypatch):
    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker

    orig = CrossEncoderRanker.score_pairs
    monkeypatch.setattr(CrossEncoderRanker, "score_pairs",
                        lambda self, pairs: [s + 0.5 for s in orig(self, pairs)])


def _alter_hits(monkeypatch):
    from sgpt_tpu_torch.index import DenseIndex

    orig = DenseIndex.search_embeddings

    def search(self, q, k=10):
        scores, ids = orig(self, q, k)
        return scores, [[str((int(i) + 1) % len(self)) for i in r] for r in ids]
    monkeypatch.setattr(DenseIndex, "search_embeddings", search)


FAULTS = {"encode": _alter_embeddings, "rerank": _alter_scores, "search": _alter_hits}


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(manifest, cell, monkeypatch):
    FAULTS[cell.split(".")[0]](monkeypatch)
    out = _run(manifest, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["encode.sgpt-5.8b.beir-docs", "search.sgpt-5.8b.nq-poisson"])
def test_the_int8_control_reads_above_the_program(cell):
    """At the tiny width the control reads several times the program's gap
    (on the card, at the cells' own sizes: PERF.md)."""
    spec = tiny_spec(cell)
    sound = control.readings(spec, SEED, False, 0.5, device="cpu")["checks"]
    ctrl = control.readings(spec, SEED, True, 0.5, device="cpu")["checks"]
    for k in spec["limits"]:
        assert ctrl[k] > 2 * sound[k], (k, sound[k], ctrl[k])


def test_a_new_config_mix_cell_and_metric_are_found_as_files(manifest, tmp_path):
    """Copies the benchmark, adds only files and BENCHMARK.json entries, runs."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(manifest))
    conf = harness.load_json(root / "benchmark/configs/sgpt-5.8b.json")
    conf["name"] = "gptj-mini"
    conf["hf_config"].update(n_embd=64, n_layer=1, n_head=2, rotary_dim=8, vocab_size=300)
    (root / "benchmark/configs/gptj-mini.json").write_text(json.dumps(conf))
    mix = dict(harness.load_json(root / "benchmark/traffic/beir-docs.json"), docs_per_call=8,
               lengths={"mu": 2.5, "sigma": 0.5, "lo": 3, "hi": 40})
    (root / "benchmark/traffic/short-docs.json").write_text(json.dumps(mix))
    cell = "encode.gptj-mini.short-docs"
    (root / f"benchmark/workloads/{cell}.json").write_text(json.dumps({"limits": {"emb_rel_err": 0.05}}))
    (root / "benchmark/metrics/docs_per_call.py").write_text(
        "def read(run):\n    return run['work']['items'] / max(1, run['counters']['k1_launches'])\n")
    m["configs"].append({"name": "gptj-mini", "source": "tiny", "file": "benchmark/configs/gptj-mini.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": cell, "config": "gptj-mini", "traffic": "short-docs", "chips": 1,
                           "why": "test"})
    next(e for e in m["end_to_end"] if e["name"] == "encode_tokens_per_s")["workloads"].append(cell)
    m["per_layer"].append({"name": "docs_per_call.encode", "unit": "docs", "better": "higher",
                           "source": "program_counter", "layer": "test",
                           "moves": "encode_tokens_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    m = harness.load_json(root / "BENCHMARK.json")
    out = harness.run_cell(m, cell, SEED, 0.2, False, time.perf_counter(), device="cpu", root=root)
    assert out["correct"] and set(out["metrics"]) == {"encode_tokens_per_s", "setup_s"}
    out = harness.run_cell(m, cell, SEED, 0.2, True, time.perf_counter(), device="cpu", root=root)
    assert "docs_per_call.encode" in out["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(manifest, card, cell):
    """A short run of each cell as committed, on the card."""
    harness.set_environment()
    out = harness.run_cell(manifest, cell, SEED, 2.0, False, time.perf_counter())
    assert out["correct"], out["checks"]
    assert np.isfinite([m["value"] for m in out["metrics"].values()]).all()
