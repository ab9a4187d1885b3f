"""The port's MS MARCO training CLI end to end on the CPU: a synthetic
`data/msmarco` folder, `build_model` patched to a tiny GPT-Neo (as
tests/test_cli_training.py does for the JAX CLI), and a checkpoint that
loads back into the model."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sgpt_tpu_torch.cli import train_msmarco  # noqa: E402
from sgpt_tpu_torch.training import load_checkpoint  # noqa: E402


def _tiny_build(model_name, random_init=False, dtype_str="float32", device="cpu", seed=0):
    """`build_model` at a tiny width, its family picked by name: "6b" →
    GPT-J with its biased LM head, "bloom" → BLOOM, else GPT-Neo."""
    from sgpt_tpu.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.models import Decoder, tiny
    name = model_name.lower()
    family = "gptj" if "6b" in name else "bloom" if "bloom" in name else "neo"
    cfg = tiny(family, num_layers=1 if family == "neo" else 2, hidden_size=32, num_heads=2,
               vocab_size=256)
    model = Decoder(cfg, device=device, generator=torch.Generator().manual_seed(seed),
                    lm_head=("w", "b") if family == "gptj" else ())
    return model, cfg, SimpleTokenizer(vocab_size=256)


def _write_msmarco(data, n_queries=10, n_passages=20):
    data.mkdir()
    with open(data / "collection.tsv", "w") as f:
        for i in range(n_passages):
            f.write(f"p{i}\tpassage number {i} words here\n")
    with open(data / "queries.tsv", "w") as f:
        for i in range(n_queries):
            f.write(f"q{i}\tquery number {i}\n")
    with open(data / "ce-scores.json", "w") as f:
        json.dump({f"q{i}": {f"p{j}": float(10 - j) for j in range(n_passages)}
                   for i in range(n_queries)}, f)
    with open(data / "hard-negatives.jsonl", "w") as f:
        for i in range(n_queries):
            f.write(json.dumps({"qid": f"q{i}", "pos": [f"p{i}"],
                                "neg": {"bm25": [f"p{(i + j) % n_passages}"
                                                 for j in range(5, 10)]}}) + "\n")
    with open(data / "dev-queries.tsv", "w") as f:
        f.write("d0\tquery number 3\n")
    with open(data / "dev-qrels.tsv", "w") as f:
        f.write("d0\tp3\n")


def test_train_msmarco_cli_writes_a_checkpoint_that_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(train_msmarco, "build_model", _tiny_build)
    monkeypatch.chdir(tmp_path)
    _write_msmarco(tmp_path / "msmarco")
    out_dir = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "x", "--model_name", "tiny", "--randominit", "--device", "cpu",
        "--data_folder", str(tmp_path / "msmarco"), "--train_batch_size", "4",
        "--max_seq_length", "16", "--epochs", "1", "--lr", "1e-3", "--specb",
        "--freezenonbias", "--eval_dev", "--dev_corpus_sample", "5",
        "--model_save_path", str(out_dir)])
    out = train_msmarco.main()
    assert len(out["history"]) == 2 and all("loss" in h for h in out["history"])
    assert (out_dir / "meta.json").exists()
    assert sorted(p.name for p in (out_dir / "checkpoints").iterdir()) == ["2"]
    model, _, _ = _tiny_build("tiny", seed=5)
    tree = load_checkpoint(str(out_dir))
    model.load_state_dict(tree["model"])
    for name, p in model.state_dict().items():
        assert torch.equal(p, out["params"][name]), name


@pytest.mark.parametrize("model_name", ["6b", "bloom"])
def test_train_msmarco_cli_trains_the_families_biases(tmp_path, monkeypatch, model_name):
    """`--model_name 6b` and `bloom` with `--randominit --freezenonbias
    --gradcache --chunksize 2`: the steps run, the checkpoint loads back, and
    only biases move (BLOOM's q/k/v biases among them; GPT-J's head bias,
    named `b`, stays frozen)."""
    from sgpt_tpu_torch.training import BIAS_NAMES

    monkeypatch.setattr(train_msmarco, "build_model", _tiny_build)
    monkeypatch.chdir(tmp_path)
    _write_msmarco(tmp_path / "msmarco")
    out_dir = tmp_path / "out"
    out = train_msmarco.main(train_msmarco.parse_args([
        "--model_name", model_name, "--randominit", "--device", "cpu",
        "--data_folder", str(tmp_path / "msmarco"), "--train_batch_size", "4",
        "--max_seq_length", "16", "--epochs", "1", "--lr", "1e-3", "--specb",
        "--freezenonbias", "--gradcache", "--chunksize", "2",
        "--model_save_path", str(out_dir)]))
    assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert sorted(p.name for p in (out_dir / "checkpoints").iterdir()) == ["2"]
    model, _, _ = _tiny_build(model_name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(load_checkpoint(str(out_dir))["model"])
    moved = set()
    for name, p in model.state_dict().items():
        assert torch.equal(p, out["params"][name]), name
        if not torch.equal(p, before[name]):
            moved.add(name)
    assert moved == {n for n in before if n.rsplit(".", 1)[-1] in BIAS_NAMES}
    if model_name == "bloom":
        assert "layers.0.attn.bq" in moved
    else:
        assert "lm_head.b" in before and "lm_head.b" not in moved


def test_build_model_refuses_what_is_not_ported():
    """A checkpoint loads from a local directory only (nothing is
    downloaded), for the GPT families and, now that they are ported (their
    random-init presets: tests/test_torch_encoder_families.py), for the
    encoder families too."""
    with pytest.raises(FileNotFoundError, match="local checkpoint"):
        train_msmarco.build_model("EleutherAI/gpt-neo-125M")
    for name in ("bert-base-uncased", "google/t5-v1_1-base"):
        with pytest.raises(FileNotFoundError, match="local checkpoint"):
            train_msmarco.build_model(name, device="cpu")
