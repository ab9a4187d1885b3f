"""The port's meshes (`sgpt_tpu_torch.parallel`) == `sgpt_tpu.parallel` on the CPU.

The JAX side runs on the forced 8-device XLA CPU mesh (tests/conftest.py);
the port's meshes are `["cpu"] * n` device lists, the same (dp, tp) shape.
Same numpy weights on both sides (`params_from_jax`), fp32 at
matmul_precision "highest".

  * arrangement: `make_mesh` shapes (dp=-1 and prefixes included) and
    refusals against JAX's, and `arrange_devices` on the JAX tests' stub
    devices (slices, interleaved order, tp across slices, uneven slices)
    against the JAX function;
  * specs and shards: `param_specs` for every leaf of tiny GPT-Neo, GPT-J
    and BLOOM, float and int8, against the JAX spec tree with its axes
    mapped to the port's layout (the layer axis dropped, linear weights
    transposed); every shard of `shard_params` equal bit for bit to the
    JAX sharded array's shard on the same mesh position (transposed);
  * the tp forward: `Decoder.forward(tp_mesh=)` against the JAX forward of
    `shard_params`-sharded parameters under `tp_mesh=` at (dp, tp) = (1, 2),
    (2, 2) and (1, 4): GPT-Neo with local layers (window 8 < T), GPT-J with
    rotary and Dh 16, BLOOM with ALiBi, float (atol 1e-5 on valid
    positions) and int8 (2 % of the largest |value|, the rule of
    tests/test_torch_quant.py); a config with H % tp != 0 (JAX falls back
    to unsharded attention); the LM head (gathered vocab shards) and the
    tied head (summed hidden shards).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgpt_tpu.models.decoder as jdec  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.ops import quant as jq  # noqa: E402
from sgpt_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from sgpt_tpu.parallel import mesh as jmesh  # noqa: E402
from sgpt_tpu.parallel import param_specs as jax_param_specs  # noqa: E402
from sgpt_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.models.params import TABLES  # noqa: E402
from sgpt_tpu_torch.ops import quant as pq  # noqa: E402
from sgpt_tpu_torch.parallel import (Mesh, arrange_devices, make_mesh, param_specs,  # noqa: E402
                                     shard_params)

# tiny configs, 2 layers, D 64, H 4, vocab 128: GPT-Neo's global and local
# (window 8) layers alternate; GPT-J has rotary and Dh 16; BLOOM ALiBi
FAMILIES = ["neo", "gptj", "bloom"]
MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other test processes on the host's
    cores, a pool of threads makes many small operations wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(family, int8=False, **kw):
    """(JAX config, JAX params, port config, port model), int8 on both sides
    with `int8`: the JAX tree quantized, the port model quantized."""
    jcfg = jax_tiny(family, num_layers=2, vocab_size=128, **kw)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    if int8:
        jparams = jq.quantize_decoder_params(jparams)
        model = pq.quantize_decoder_params(model)
    return jcfg, jparams, cfg, model


def _meshes(dp, tp):
    return jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp]), \
        make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _jax_leaf(tree, name):
    """The JAX leaf (array or spec) of a port state-dict name: (leaf, layer
    index or None)."""
    keys = name.split(".")
    layer = None
    if keys[0] == "layers":
        layer, keys = int(keys[1]), ["layers"] + keys[2:]
    leaf = tree
    for k in keys:
        leaf = leaf[k]
    return leaf, layer


def _transposed(name, arr, layer) -> bool:
    """params_from_jax transposes every 2-D leaf but the tables."""
    return arr.ndim - (layer is not None) == 2 and name.split(".")[-1] not in TABLES


# -- arrangement ---------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", [(-1, 1), (-1, 2), (-1, 8), (2, 2), (1, 4), (8, 1)])
def test_make_mesh_shapes_match_jax(dp, tp):
    want = jax_make_mesh(dp=dp, tp=tp)
    got = make_mesh(dp=dp, tp=tp, devices=["cpu"] * 8)
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


@pytest.mark.parametrize("dp,tp", [(-1, 3), (3, 3)])
def test_make_mesh_refusals_match_jax(dp, tp):
    with pytest.raises(ValueError):
        jax_make_mesh(dp=dp, tp=tp)
    with pytest.raises(ValueError):
        make_mesh(dp=dp, tp=tp, devices=["cpu"] * 8)


class _StubDev:
    """A fake device with the topology attribute the arrangement reads."""

    def __init__(self, i, slice_index=None):
        self.id = i
        if slice_index is not None:
            self.slice_index = slice_index


STUB_CASES = {   # the JAX tests' cases (tests/test_parallel.py)
    "multislice": ([(i, i // 4) for i in range(8)], 4, 2),
    "interleaved": ([(i, i % 2) for i in range(8)], 4, 2),
    "tp_across_dcn": ([(i, i // 4) for i in range(8)], 1, 8),
    "uneven": ([(i, 0) for i in range(4)] + [(4 + i, 1) for i in range(2)], 3, 2),
    "single_slice": ([(i, None) for i in range(8)], 2, 4),
}


@pytest.mark.parametrize("case", list(STUB_CASES))
def test_arrange_devices_matches_jax(case):
    spec, dp, tp = STUB_CASES[case]
    devs = [_StubDev(i, s) for i, s in spec]
    try:
        want = [[d.id for d in row] for row in jmesh.arrange_devices(devs, dp, tp)]
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[0]):
            arrange_devices(devs, dp, tp)
        return
    assert [[d.id for d in row] for row in arrange_devices(devs, dp, tp)] == want


def test_mesh_of_repeated_devices():
    mesh = make_mesh(dp=2, tp=2, devices=["cpu", "cpu", "cpu", "cpu"])
    assert isinstance(mesh, Mesh) and mesh.shape == {"dp": 2, "tp": 2}
    assert list(mesh.devices[1]) == [torch.device("cpu")] * 2 and mesh.devices.size == 4
    assert mesh == make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert mesh != make_mesh(dp=4, tp=1, devices=["cpu"] * 4)


# -- specs and shards ------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_param_specs_match_jax(family, int8):
    _, jparams, _, model = _pair(family, int8)
    jspecs = jax_param_specs(jparams)
    specs = param_specs(model)
    assert set(specs) == set(model.state_dict())
    for name, spec in specs.items():
        leaf, layer = _jax_leaf(jparams, name)
        transposed = _transposed(name, leaf, layer)
        jspec, _ = _jax_leaf(jspecs, name)
        jspec = tuple(jspec) + (None,) * (leaf.ndim - len(jspec))
        if layer is not None:
            assert jspec[0] is None, name
            jspec = jspec[1:]
        assert spec == (jspec[::-1] if transposed else jspec), name
    assert sum("tp" in s for s in specs.values()) > 0


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_shards_match_jax_addressable_shards(family, int8):
    _, jparams, _, model = _pair(family, int8)
    jm, mesh = _meshes(2, 2)
    jsharded = jax_shard_params(jparams, jm)
    sharded = shard_params(model, mesh)
    assert shard_params(sharded, mesh) is sharded
    for i in range(2):
        for j in range(2):
            shard = sharded.groups[i].shards[j].state_dict()
            assert set(shard) == set(model.state_dict())
            for name, got in shard.items():
                arr, layer = _jax_leaf(jsharded, name)
                (data,) = [s.data for s in arr.addressable_shards
                           if s.device == jm.devices[i, j]]
                want = np.asarray(data)
                if layer is not None:
                    want = want[layer]
                if _transposed(name, arr, layer):
                    want = want.T
                assert got.dtype == model.state_dict()[name].dtype, name
                assert got.shape == want.shape, name
                np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                              err_msg=name)


def test_shard_params_refuses_indivisible_axes_and_another_mesh():
    _, _, _, model = _pair("neo")
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        shard_params(model, make_mesh(dp=1, tp=3, devices=["cpu"] * 3))
    sharded = shard_params(model, make_mesh(dp=1, tp=2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="sharded over"):
        shard_params(sharded, make_mesh(dp=2, tp=1, devices=["cpu"] * 2))


# -- the tp forward --------------------------------------------------------------

def _inputs(cfg, B=4, T=20, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([T, 15, 3, 11])[:B, None]).astype(np.int32)
    return ids, mask


def _forward_pair(family, int8, dp, tp, **kw):
    jcfg, jparams, cfg, model = _pair(family, int8, **kw)
    jm, mesh = _meshes(dp, tp)
    ids, mask = _inputs(cfg)
    want = np.asarray(jdec.forward(jax_shard_params(jparams, jm), jnp.asarray(ids),
                                   jnp.asarray(mask), jcfg, tp_mesh=jm))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), tp_mesh=mesh).numpy()
    valid = mask[..., None].astype(bool)
    return np.where(valid, got, 0), np.where(valid, want, 0)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("family", FAMILIES)
def test_tp_forward_matches_jax_sharded_forward(family, dp, tp, int8):
    got, want = _forward_pair(family, int8, dp, tp)
    if int8:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("family", ["neo", "bloom"])
def test_heads_not_divisible_by_tp_match_jax(family):
    """H = 2 heads over tp = 4: JAX keeps the projections sharded and runs
    attention on every head unsharded; so does the port."""
    got, want = _forward_pair(family, False, 1, 4, num_heads=2)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("family", ["neo", "gptj"])
def test_tp_lm_head_matches_jax(family):
    """GPT-J's separate, biased head (vocab shards gathered) and GPT-Neo's
    head tied to the hidden-sharded wte (partial products summed): the
    logits of the tp forward equal JAX's logits of its sharded forward."""
    jcfg, jparams, cfg, model = _pair(family)
    if family == "gptj":
        rng = np.random.default_rng(7)
        jparams = {**jparams, "lm_head": {
            "w": jnp.asarray(0.02 * rng.standard_normal((cfg.hidden_size, 128)), jnp.float32),
            "b": jnp.asarray(0.02 * rng.standard_normal(128), jnp.float32)}}
        model = Decoder(cfg, device="cpu",
                        weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    jm, mesh = _meshes(1, 2)
    ids, mask = _inputs(cfg)
    sp = jax_shard_params(jparams, jm)
    want = np.asarray(jdec.logits(sp, jdec.forward(sp, jnp.asarray(ids), jnp.asarray(mask),
                                                   jcfg, tp_mesh=jm), jcfg))
    sharded = shard_params(model, mesh)
    with torch.no_grad():
        got = sharded.logits(sharded(torch.from_numpy(ids), torch.from_numpy(mask))).numpy()
    valid = mask[..., None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=1e-5)


def test_tp_forward_hidden_states_and_packed_rows():
    """`output_hidden_states` (every layer's states) and packed rows
    (segment ids, per-segment positions: ALiBi key positions restart) under
    tp equal the meshless forward."""
    _, _, cfg, model = _pair("bloom")
    ids, mask = _inputs(cfg)
    seg = np.repeat(np.array([[0] * 8 + [1] * 12]), 4, 0).astype(np.int32)
    pos = np.repeat(np.concatenate([np.arange(8), np.arange(12)])[None], 4, 0).astype(np.int32)
    mask = np.ones_like(ids)
    kw = dict(segment_ids=torch.from_numpy(seg), position_ids=torch.from_numpy(pos))
    mesh = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    with torch.no_grad():
        args = (torch.from_numpy(ids), torch.from_numpy(mask))
        np.testing.assert_allclose(model(*args, tp_mesh=mesh, **kw).numpy(),
                                   model(*args, **kw).numpy(), atol=1e-5)
        got = model(*args, tp_mesh=mesh, output_hidden_states=True)
        want = model(*args, output_hidden_states=True)
    assert got.shape == want.shape == (cfg.num_layers + 1, 4, 20, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
