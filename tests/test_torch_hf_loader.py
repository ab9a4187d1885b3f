"""The port's HF checkpoint loader (`sgpt_tpu_torch.models.hf_loader`) ==
the JAX converter (`sgpt_tpu.models.hf_loader.convert_hf_state_dict`).

Random-init HF models built from local `transformers` configs (nothing is
downloaded), as `tests/test_models_parity.py` builds them: `GPTNeoModel`,
`GPTJForCausalLM` (GPT-J's separate, biased head) and `BloomModel`, each
saved by `save_pretrained` as one safetensors file, as a `.bin` and as
sharded safetensors (an `*.index.json` and one file per shard). The port's
`load_pretrained` reads the directory with torch and json alone; its
forward and logits must equal the JAX decoder's on the weights the JAX
converter makes from the same HF state dict, at fp32 tolerance (1e-5
relative, 1e-5 absolute: only the summation order differs).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.models import hf_loader as jax_hf  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu.models.decoder import logits as jax_logits  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config  # noqa: E402
from sgpt_tpu_torch.models import hf_loader  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5


def _hf_model(family):
    torch.manual_seed(0)
    if family == "neo":
        c = transformers.GPTNeoConfig(
            vocab_size=257, hidden_size=64, num_layers=4, num_heads=4,
            attention_types=[[["global", "local"], 2]], window_size=8,
            max_position_embeddings=128, intermediate_size=256,
            resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0)
        return transformers.GPTNeoModel(c)
    if family == "gptj":
        c = transformers.GPTJConfig(
            vocab_size=257, n_embd=64, n_layer=3, n_head=4, rotary_dim=8,
            n_positions=128, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
        return transformers.GPTJForCausalLM(c)
    c = transformers.BloomConfig(vocab_size=257, hidden_size=64, n_layer=3, n_head=4,
                                 hidden_dropout=0.0, attention_dropout=0.0)
    return transformers.BloomModel(c)


LAYOUTS = {  # name: save_pretrained keywords
    "safetensors": dict(safe_serialization=True),
    "bin": dict(safe_serialization=False),
    "sharded": dict(safe_serialization=True, max_shard_size="40KB"),
}


def _saved(tmp_path, family, layout):
    model = _hf_model(family).eval()
    out = tmp_path / f"{family}-{layout}"
    model.save_pretrained(out, **LAYOUTS[layout])
    return model, out


def _jax_side(model, family):
    jcfg = jax_hf.config_from_hf(model.config, family)
    sd = dict(model.state_dict())
    if getattr(model.config, "tie_word_embeddings", True):
        sd.pop("lm_head.weight", None)
        sd.pop("lm_head.bias", None)
    return jcfg, jax_hf.convert_hf_state_dict(sd, jcfg, family)


def _batch(vocab, T=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (3, T)).astype(np.int32)
    mask = np.ones((3, T), np.int32)
    mask[1, T - 5:] = 0
    mask[2, 7:] = 0
    return ids, mask


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", ["neo", "gptj", "bloom"])
def test_load_pretrained_matches_jax_converter(tmp_path, family, layout):
    model, path = _saved(tmp_path, family, layout)
    files = sorted(p.name for p in path.iterdir())
    if layout == "sharded":
        assert "model.safetensors.index.json" in files and len(files) > 3, files
    sd, cfg = hf_loader.load_pretrained(str(path))
    jcfg, jparams = _jax_side(model, family)
    assert cfg == from_jax_config(jcfg)
    assert ("lm_head.w" in sd) == (family == "gptj") and ("lm_head.b" in sd) == (family == "gptj")
    port = Decoder(cfg, device="cpu", weights=sd)
    ids, mask = _batch(cfg.vocab_size)
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  output_hidden_states=True))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask),
                   output_hidden_states=True).numpy()
    valid = mask[None, :, :, None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0),
                               rtol=RTOL, atol=ATOL)
    h = got[-1]
    with torch.no_grad():
        lg = port.logits(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(lg, np.asarray(jax_logits(jparams, jnp.asarray(h), jcfg)),
                               rtol=RTOL, atol=ATOL)


def test_gptj_head_is_kept_and_matches_hf():
    """GPT-J's untied, biased head: the port's logits equal HF's own
    `GPTJForCausalLM` logits (fp32, no padding)."""
    model = _hf_model("gptj").eval()
    cfg = hf_loader.config_from_hf(model.config, "gptj")
    port = Decoder(cfg, device="cpu",
                   weights=hf_loader.convert_hf_state_dict(model.state_dict(), cfg, "gptj"))
    ids = torch.from_numpy(_batch(257, T=16)[0]).long()
    with torch.no_grad():
        want = model(ids).logits.numpy()
        got = port.logits(port(ids, torch.ones_like(ids))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["neo", "gptj", "bloom"])
def test_hf_state_dict_inverts_the_conversion(family):
    """`hf_state_dict` gives back the HF model's own tensors under its own
    names (less the 'transformer.' prefix), BLOOM's fused q/k/v included."""
    model = _hf_model(family)
    cfg = hf_loader.config_from_hf(model.config, family)
    theirs = hf_loader._strip_prefix(model.state_dict())
    ours = hf_loader.convert_hf_state_dict(theirs, cfg, family)
    back = hf_loader.hf_state_dict(ours, cfg, family)
    assert set(back) == set(theirs)
    assert all(torch.equal(back[k], theirs[k]) for k in back)


@pytest.mark.parametrize("family", ["neo", "gptj", "bloom"])
def test_config_from_json_dict_equals_config_object(tmp_path, family):
    model, path = _saved(tmp_path, family, "safetensors")
    with open(path / "config.json") as f:
        raw = json.load(f)
    assert (hf_loader.config_from_hf(raw, family)
            == hf_loader.config_from_hf(model.config, family)
            == from_jax_config(jax_hf.config_from_hf(model.config, family)))
    assert hf_loader.guess_family(str(path)) == jax_hf.guess_family(str(path))


def test_bloom_legacy_config_keys():
    """Published BLOOM config.json files name the width `n_embed`."""
    raw = {"model_type": "bloom", "vocab_size": 250880, "n_embed": 2048, "n_layer": 24,
           "n_head": 16, "layer_norm_epsilon": 1e-5}
    from sgpt_tpu_torch.models import bloom
    assert hf_loader.config_from_hf(raw, "bloom") == bloom("1b7")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int64"])
def test_safetensors_reader_and_writer_match_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    tensors = {f"t{i}": torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        getattr(torch, dtype)) for i, s in enumerate([(3, 5), (7,), (2, 3, 4), (0,)])}
    st.save_file(tensors, str(tmp_path / "a.safetensors"))
    hf_loader.save_safetensors(tensors, str(tmp_path / "b.safetensors"))
    for got in (hf_loader.read_safetensors(str(tmp_path / "a.safetensors")),
                st.load_file(str(tmp_path / "b.safetensors"))):
        assert set(got) == set(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_reader_needs_no_safetensors_or_transformers(tmp_path):
    """In a process where `safetensors` and `transformers` cannot be
    imported, `load_pretrained` reads a saved checkpoint."""
    _, path = _saved(tmp_path, "bloom", "sharded")
    script = (
        "import sys\n"
        "sys.modules['safetensors'] = None\nsys.modules['transformers'] = None\n"
        "from sgpt_tpu_torch.models import Decoder\n"
        "from sgpt_tpu_torch.models.hf_loader import load_pretrained\n"
        f"sd, cfg = load_pretrained({str(path)!r})\n"
        "Decoder(cfg, device='cpu', weights=sd)\n"
        "print(len(sd))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 10


def test_not_a_checkpoint_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="local checkpoint"):
        hf_loader.load_pretrained(str(tmp_path / "EleutherAI/gpt-neo-125M"))
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt_neo"}))
    with pytest.raises(FileNotFoundError, match="safetensors"):
        hf_loader._read_weights(str(tmp_path))
