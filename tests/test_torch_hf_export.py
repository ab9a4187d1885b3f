"""The port's HF export == the JAX package's, and it round-trips through the
port's loader.

For GPT-Neo, GPT-J (with its separate biased head, and without) and BLOOM,
at `tiny(num_layers=2, hidden_size=32, num_heads=4, vocab_size=64)`, the
same weights (the JAX `init_params`, carried over by `params_from_jax`) go
through the JAX `to_hf_state_dict` and the port's, in the `base`,
`causal_lm` and `auto` styles: the same names, and every tensor equal bit
for bit (the export only moves values). `save_hf_checkpoint` then writes a
directory that `hf_loader.load_pretrained` reads back into the same state
dict and config, and a `Decoder` built from it gives the same hidden states
bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.hf_export import to_hf_state_dict as jax_export  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.models.hf_export import (hf_config, save_hf_checkpoint,  # noqa: E402
                                             to_hf_state_dict)
from sgpt_tpu_torch.models.hf_loader import load_pretrained  # noqa: E402

FAMILIES = {"neo": ("neo", False), "gptj": ("gptj", False), "gptj_head": ("gptj", True),
            "bloom": ("bloom", False)}


def _weights(case):
    family, head = FAMILIES[case]
    jcfg = jax_tiny(family, num_layers=2, hidden_size=32, num_heads=4, vocab_size=64)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    if head:  # GPT-J's separate biased LM head
        jparams["lm_head"] = {"w": jax.random.normal(jax.random.key(3), (32, 64)),
                              "b": jax.random.normal(jax.random.key(4), (64,))}
    cfg = from_jax_config(jcfg)
    return family, jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


@pytest.mark.parametrize("style", ["base", "causal_lm", "auto"])
@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_state_dict_equals_jax_bit_for_bit(case, style):
    family, jcfg, jparams, cfg, sd = _weights(case)
    want = jax_export(jparams, jcfg, family, style=style)
    got = to_hf_state_dict(sd, cfg, family, style=style)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name, arr in want.items():
        t = got[name]
        assert t.dtype == torch.float32 and t.device.type == "cpu", name
        np.testing.assert_array_equal(t.numpy(), arr, err_msg=name)


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_checkpoint_round_trips_through_the_loader(tmp_path, case):
    family, _, _, cfg, sd = _weights(case)
    model = Decoder(cfg, device="cpu", weights=sd)
    save_hf_checkpoint(str(tmp_path), model, cfg, family)
    assert sorted(os.listdir(tmp_path)) == ["config.json", "pytorch_model.bin"]
    back, back_cfg = load_pretrained(str(tmp_path))
    same = dict(intermediate_size=cfg.intermediate_size)
    if family == "bloom":  # ALiBi: BLOOM's config.json names no position limit
        same["max_position_embeddings"] = cfg.max_position_embeddings
    assert back_cfg.replace(**same) == cfg
    assert set(back) == set(sd)
    for name, t in sd.items():
        assert torch.equal(back[name], t), name
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 9)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        assert torch.equal(Decoder(back_cfg, device="cpu", weights=back)(ids, mask),
                           model(ids, mask))


def test_encoder_families_name_their_roadmap_item():
    """The JAX export has no BERT or T5 branch and raises ValueError("unknown
    family"); now that the encoder families are ported (loading them is
    tests/test_torch_encoder_families.py's), the port raises the same."""
    _, jcfg, jparams, cfg, sd = _weights("neo")
    for family in ("bert", "t5"):
        with pytest.raises(ValueError, match="unknown family"):
            jax_export(jparams, jcfg, family)
        with pytest.raises(ValueError, match="unknown family"):
            to_hf_state_dict(sd, cfg, family)
        with pytest.raises(ValueError, match="unknown family"):
            hf_config(cfg, family)
