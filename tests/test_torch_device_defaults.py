"""The port's entry points run on the card unless the caller asks for the
CPU: `Decoder`, `EmbeddingEngine`, `CrossEncoderRanker`, `DenseIndex` (and
`DenseIndex.load`), `CLIP` and the CLIs' `build_model` (every preset
family, the encoder families included, and a local checkpoint) default to
device "cuda", and without a card they raise rather than fall back to the
CPU; so do `make_mesh()` (every visible card) and a mesh of CUDA devices,
and the mesh path of `beir_retriever`, `sgptce` and `serve` (`--dp`/`--tp`
over the default `--device cuda`): no silent CPU mesh. So do training under a
mesh and sequence parallelism: `ContrastiveTrainer(mesh=make_mesh())`,
`sp_mesh=` on the trainer, the engine and TSDAE, and `train_msmarco` /
`train_nli --dp 2 --tp 2` over the default `--device cuda`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sgpt_tpu_torch.cli import (beir_retriever, serve, sgptce, train_msmarco,  # noqa: E402
                                 train_nli)
from sgpt_tpu_torch.cli.common import build_model  # noqa: E402
from sgpt_tpu_torch.crossencoder import CrossEncoderRanker  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.index import DenseIndex  # noqa: E402
from sgpt_tpu_torch.models import Decoder, tiny  # noqa: E402
from sgpt_tpu_torch.models.clip import CLIP, clip_tiny  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig, TSDAETrainer  # noqa: E402

CFG = tiny("neo", num_layers=1, hidden_size=32, num_heads=2)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _save_index(tmp_path):
    idx = DenseIndex(8, device="cpu")
    idx.add(np.ones((2, 8), np.float32))
    idx.save(str(tmp_path / "i.npz"))
    return str(tmp_path / "i.npz")


def _tiny_checkpoint(tmp):
    transformers = pytest.importorskip("transformers")
    c = transformers.GPTNeoConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                                  attention_types=[[["global", "local"], 1]],
                                  max_position_embeddings=64)
    transformers.GPTNeoModel(c).save_pretrained(tmp / "checkpoint")
    return str(tmp / "checkpoint")


ENTRY_POINTS = {
    "Decoder": lambda tmp: Decoder(CFG),
    "EmbeddingEngine": lambda tmp: EmbeddingEngine(Decoder(CFG, device="cpu"), CFG,
                                                   SimpleTokenizer(CFG.vocab_size)),
    "CrossEncoderRanker": lambda tmp: CrossEncoderRanker(Decoder(CFG, device="cpu"), CFG,
                                                         SimpleTokenizer(CFG.vocab_size)),
    "DenseIndex": lambda tmp: DenseIndex(16),
    "DenseIndex.load": lambda tmp: DenseIndex.load(_save_index(tmp)),
    "build_model": lambda tmp: build_model("gpt-neo-125m", random_init=True),
    "build_model gpt-j": lambda tmp: build_model("EleutherAI/gpt-j-6b", random_init=True),
    "build_model bloom": lambda tmp: build_model("bigscience/bloom-1b7", random_init=True),
    "build_model checkpoint": lambda tmp: build_model(_tiny_checkpoint(tmp)),
    "build_model bert": lambda tmp: build_model("bert-base-uncased", random_init=True),
    "build_model t5": lambda tmp: build_model("google/t5-v1_1-base", random_init=True),
    "CLIP": lambda tmp: CLIP(clip_tiny()),
    "make_mesh": lambda tmp: make_mesh(),
    "make_mesh cuda devices": lambda tmp: make_mesh(dp=2, devices=["cuda:0", "cuda:0"]),
    "beir_retriever --dp 2": lambda tmp: beir_retriever.main(beir_retriever.parse_args(
        ["--randominit", "--datapath", str(tmp), "--dp", "2"])),
    "sgptce --tp 2": lambda tmp: sgptce.main(sgptce.parse_args(
        ["--randominit", "--datadir", str(tmp), "--tp", "2"])),
    "serve --dp 2": lambda tmp: serve.main(["--modelname", "gpt-neo-125m", "--randominit",
                                            "--dp", "2", "--no-warmup"]),
    "ContrastiveTrainer mesh": lambda tmp: ContrastiveTrainer(
        Decoder(CFG, device="cpu"), CFG, SimpleTokenizer(CFG.vocab_size), TrainConfig(),
        mesh=make_mesh(dp=2, tp=2)),
    "ContrastiveTrainer sp_mesh": lambda tmp: ContrastiveTrainer(
        Decoder(CFG, device="cpu"), CFG, SimpleTokenizer(CFG.vocab_size),
        TrainConfig(max_seq_len=64), sp_mesh=make_mesh(dp=2)),
    "EmbeddingEngine sp_mesh": lambda tmp: EmbeddingEngine(
        Decoder(CFG, device="cpu"), CFG, SimpleTokenizer(CFG.vocab_size), sp_mesh=make_mesh()),
    "TSDAETrainer sp_mesh": lambda tmp: TSDAETrainer(
        Decoder(CFG, device="cpu"), CFG, SimpleTokenizer(CFG.vocab_size),
        sp_mesh=make_mesh(dp=2)),
    "train_msmarco --dp 2 --tp 2": lambda tmp: train_msmarco.main(train_msmarco.parse_args(
        ["--randominit", "--data_folder", str(tmp), "--dp", "2", "--tp", "2"])),
    "train_nli --dp 2": lambda tmp: train_nli.main(train_nli.parse_args(
        ["--randominit", "--nli_path", str(tmp / "nli.tsv"), "--dp", "2"])),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_is_the_card_and_raises_without_one(name, tmp_path):
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name](tmp_path)


@pytest.mark.parametrize("name", ["Decoder", "EmbeddingEngine", "CrossEncoderRanker",
                                  "DenseIndex"])
def test_explicit_cpu_runs_on_the_cpu(name):
    if name == "Decoder":
        obj = Decoder(CFG, device="cpu")
        assert next(obj.parameters()).device.type == "cpu"
    elif name == "EmbeddingEngine":
        obj = EmbeddingEngine(Decoder(CFG, device="cpu"), CFG, SimpleTokenizer(CFG.vocab_size),
                              device="cpu")
        assert obj.device.type == "cpu" and obj.encode(["a b c"]).shape == (1, 32)
    elif name == "CrossEncoderRanker":
        obj = CrossEncoderRanker(Decoder(CFG, device="cpu"), CFG, SimpleTokenizer(CFG.vocab_size),
                                 device="cpu")
        scores = obj.predict([("a query", "a document")])
        assert obj.device.type == "cpu" and len(scores) == 1 and np.isfinite(scores[0])
    else:
        assert DenseIndex(16, device="cpu").device.type == "cpu"
