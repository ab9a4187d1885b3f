"""Port's GPT-Neo decoder == `sgpt_tpu.models.decoder.forward` on the same weights.

`tiny("neo")` (local window 8) with the JAX `init_params` converted by
`params_from_jax`. Compared at valid (unpadded) positions: padded query rows
that a local window leaves with no valid key differ by design (the JAX XLA
path adds -1e9, the fused kernel and the port replace by -1e9), and no valid
position reads them. fp32 tolerance 1e-4; bf16 5e-2.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, from_jax_config, gpt_neo,  # noqa: E402
                                   params_from_jax, tiny)
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402


def _pair(dtype=jnp.float32, **kw):
    jcfg = jax_tiny("neo", num_layers=3, **kw).replace(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _batch(T, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (3, T)).astype(np.int32)
    mask = np.ones((3, T), np.int32)
    mask[1, T - 2:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("T", [6, 20])  # below and above the local window (8)
def test_hidden_states_match_jax_fp32(T):
    jcfg, jparams, cfg, model = _pair()
    ids, mask = _batch(T, cfg.vocab_size)
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  output_hidden_states=True))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                output_hidden_states=True).detach().numpy()
    assert got.shape == want.shape == (cfg.num_layers + 1, 3, T, cfg.hidden_size)
    valid = mask[None, :, :, None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=1e-4)
    final = model(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_array_equal(final, got[-1])


def test_hidden_states_match_jax_bf16():
    jcfg, jparams, cfg, model = _pair(dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16 and model.wte.dtype == torch.bfloat16
    ids, mask = _batch(20, cfg.vocab_size, seed=1)
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                  jcfg).astype(jnp.float32))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask)).float().detach().numpy()
    valid = mask[:, :, None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=5e-2)


def test_packed_segments_and_positions_match_jax():
    jcfg, jparams, cfg, model = _pair()
    T = 24
    ids, mask = _batch(T, cfg.vocab_size, seed=2)
    seg = np.zeros((3, T), np.int32)
    seg[:, 10:] = 1
    pos = np.tile(np.concatenate([np.arange(10), np.arange(T - 10)]), (3, 1)).astype(np.int32)
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  segment_ids=jnp.asarray(seg), position_ids=jnp.asarray(pos)))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                segment_ids=torch.from_numpy(seg),
                position_ids=torch.from_numpy(pos)).detach().numpy()
    valid = mask[:, :, None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=1e-4)
    with pytest.raises(ValueError, match="position_ids"):
        model(torch.from_numpy(ids), torch.from_numpy(mask), segment_ids=torch.from_numpy(seg))


@pytest.mark.parametrize("family", ["gptj", "bloom", "bert", "t5"])
def test_other_families_raise(family):
    """Every family builds from the JAX config (the encoder families since
    they were ported: tests/test_torch_encoder_families.py holds their
    forwards to JAX's), and raises on a flag value the forward has no
    meaning for, where the JAX forward would quietly take a default branch,
    or on local layers (or ALiBi) under bidirectional attention, which no
    family has and the plain attention does not implement."""
    cfg = from_jax_config(jax_tiny(family))
    Decoder(cfg, device="cpu")
    for bad in (dict(norm_style="batch"), dict(mlp_activation="swish"),
                dict(position_embedding="sinusoidal"),
                dict(bidirectional=True, attention_layout="alternating")):
        with pytest.raises(ValueError, match=next(iter(bad))):
            Decoder(cfg.replace(**bad), device="cpu")


TP_MESH = make_mesh(dp=1, tp=2, devices=["cpu", "cpu"])
TSDAE_COND = dict(cond=torch.zeros(1, 64), cond_params={"w": torch.zeros(1, 64, 64),
                                                        "b": torch.zeros(1, 64)})


SP_MESH = make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])


@pytest.mark.parametrize("kw,error,match", [
    (dict(sp_mesh=SP_MESH, segment_ids=torch.zeros(1, 4, dtype=torch.int32),
          position_ids=torch.zeros(1, 4, dtype=torch.int32)), NotImplementedError, "packing"),
    (dict(tp_mesh=TP_MESH, **TSDAE_COND), NotImplementedError, "sp_mesh only"),
    (dict(sp_mesh=SP_MESH, tp_mesh=TP_MESH), ValueError, "not both")])
def test_unported_forward_arguments_raise(kw, error, match):
    """What the JAX forward refuses raises: packed rows under sequence
    parallelism (ring attention), TSDAE's conditioning under a tp mesh
    (JAX's TSDAE takes sp_mesh only), and an sp and a tp mesh together
    (tests/test_torch_ring_attention.py: the other sp refusals)."""
    model = Decoder(tiny("neo", num_layers=1), device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(error, match=match):
        model(ids, torch.ones_like(ids), **kw)


def test_tp_mesh_forward_matches_the_meshless_forward():
    """`tp_mesh=` runs the forward tensor-parallel (tests/test_torch_parallel.py
    holds it to the JAX sharded forward): the meshless states within 1e-5."""
    model = Decoder(tiny("neo", num_layers=2), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 257, (2, 12)))
    mask = torch.ones_like(ids)
    mask[1, 7:] = 0
    with torch.no_grad():
        got, want = model(ids, mask, tp_mesh=TP_MESH), model(ids, mask)
    np.testing.assert_allclose(got[mask.bool()].numpy(), want[mask.bool()].numpy(), atol=1e-5)


def test_params_from_jax_refuses_leftover_and_missing_leaves():
    jcfg, jparams, cfg, _ = _pair()
    tree = jax.tree.map(np.asarray, jparams)
    tree["lm_head"] = {"w": np.zeros((cfg.hidden_size, cfg.vocab_size), np.float32)}
    assert params_from_jax(tree, cfg)["lm_head.w"].shape == (cfg.vocab_size, cfg.hidden_size)
    del tree["lm_head"]
    tree["wtt"] = np.zeros((2, cfg.hidden_size), np.float32)  # BERT's token types
    with pytest.raises(ValueError, match="wtt"):
        params_from_jax(tree, cfg)
    del tree["wtt"]
    tree["layers"]["attn"]["wq"] = {"q": np.zeros(1, np.int8), "s": np.zeros(1)}  # int8 leaf
    with pytest.raises(ValueError, match="int8 leaf of shape"):   # of the wrong shape
        params_from_jax(tree, cfg)
    del tree["layers"]["attn"]["wq"]
    with pytest.raises(KeyError, match="wq"):
        params_from_jax(tree, cfg)


def test_config_mirrors_jax():
    from sgpt_tpu.models import gpt_neo as jax_gpt_neo
    jcfg = jax_gpt_neo("125m")
    cfg = from_jax_config(jcfg)
    assert cfg == gpt_neo("125m")
    assert cfg.local_flags() == jcfg.local_flags()
    assert not cfg.scale_attn and cfg.local_window == 256
    assert from_jax_config(jcfg.replace(dtype=jnp.bfloat16)).dtype == torch.bfloat16


def test_init_distribution_and_seed():
    cfg = tiny("neo", num_layers=2, hidden_size=64, vocab_size=2000)
    a = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    b = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert abs(a["wte"].std().item() - 0.02) < 1e-3
    assert torch.all(a["layers.0.ln1.scale"] == 1) and torch.all(a["layers.0.attn.bo"] == 0)
    assert a["layers.1.mlp.wi"].shape == (4 * 64, 64)  # torch [out, in]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1.6e-2)])
def test_layer_norm_matches_jax(dtype, atol):
    """fp32 statistics and affine, cast back; bf16 differs by at most one
    rounding of the output (1 ulp at |y| < 4)."""
    from sgpt_tpu.models.decoder import layer_norm as jax_layer_norm
    from sgpt_tpu_torch.models.decoder import layer_norm
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((4, 7, 96), (96,), (96,)))
    x = 3 * x + 1
    got = layer_norm(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w, b)), 1e-5)
    want = jax_layer_norm(*(jnp.asarray(a).astype(dtype) for a in (x, w, b)), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)
