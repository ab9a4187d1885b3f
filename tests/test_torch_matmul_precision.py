"""The port honours `DecoderConfig.matmul_precision` as the JAX package does.

"highest" keeps float32 products strict (both TF32 flags False), "high" and
"default" allow TF32 (both True); the scope restores the flags it found,
also when its body raises. `Decoder.forward` runs under the model's
precision (the JAX decoder wraps its forward in
`jax.default_matmul_precision`), and so does the trainer's
`_loss_and_grads`, whose backward products run outside the forward: the
flags are read from inside a forward hook and from autograd hooks. The CLI's
`build_model` sets "default", as the JAX one does; the parity configs stay at
"highest". The flags change nothing on the CPU, so this checks the scopes,
not the arithmetic.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import sgpt_tpu.models as jax_models  # noqa: E402
from sgpt_tpu.cli import common as jax_common  # noqa: E402
from sgpt_tpu.models import gpt_neo as jax_gpt_neo  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu_torch import models as port_models  # noqa: E402
from sgpt_tpu_torch.cli import common as port_common  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, gpt_neo, tiny  # noqa: E402
from sgpt_tpu_torch.models.precision import matmul_precision  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig  # noqa: E402

TF32 = {"highest": False, "high": True, "default": True}


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


@pytest.fixture
def flags():
    """Restore both TF32 flags after the test, whatever it set."""
    saved = _flags()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _set(mm, cudnn):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cudnn


@pytest.mark.parametrize("start", [(False, True), (True, False)])
@pytest.mark.parametrize("name", sorted(TF32))
def test_scope_sets_both_flags_and_restores_them(flags, name, start):
    _set(*start)
    with matmul_precision(name):
        assert _flags() == (TF32[name], TF32[name])
    assert _flags() == start


@pytest.mark.parametrize("name", sorted(TF32))
def test_scope_restores_the_flags_when_its_body_raises(flags, name):
    _set(False, True)
    with pytest.raises(RuntimeError, match="inside"):
        with matmul_precision(name):
            assert _flags() == (TF32[name], TF32[name])
            raise RuntimeError("inside")
    assert _flags() == (False, True)


@pytest.mark.parametrize("name", ["bfloat16", "float32", "tensorfloat32", "HIGHEST", ""])
def test_unknown_precision_raises(flags, name):
    _set(False, True)
    with pytest.raises(ValueError, match="matmul_precision"):
        with matmul_precision(name):
            pass
    assert _flags() == (False, True)


def _tiny_model(precision):
    cfg = tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=128,
               matmul_precision=precision)
    return Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0)), cfg


@pytest.mark.parametrize("name", sorted(TF32))
def test_decoder_forward_runs_under_the_models_precision(flags, name):
    model, _ = _tiny_model(name)
    seen = []
    for layer in model.layers:
        layer.attn.register_forward_hook(lambda m, args, out: seen.append(_flags()))
    _set(not TF32[name], not TF32[name])
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 12)))
    out = model(ids, torch.ones(2, 12, dtype=torch.int32))
    assert out.shape == (2, 12, 32)
    assert seen == [(TF32[name], TF32[name])] * 2
    assert _flags() == (not TF32[name], not TF32[name])


BATCH = [("topic1 word3 word4", "topic1 word3 word9", "topic5 other2 other7"),
         ("topic2 word8 word1", "topic2 word8 word6", "topic6 other1 other4"),
         ("topic3 word5 word2", "topic3 word5 word0", "topic7 other3 other8"),
         ("topic4 word7 word6", "topic4 word7 word2", "topic0 other6 other5")]


@pytest.mark.parametrize("gradcache", [False, True])
@pytest.mark.parametrize("name", ["highest", "default"])
def test_trainer_backward_runs_under_the_models_precision(flags, name, gradcache):
    """The backward's products (autograd hooks on every layer's output) and
    the forward's see the model's precision, direct and under GradCache
    (whose pass 2 calls backward once a chunk)."""
    model, cfg = _tiny_model(name)
    tc = TrainConfig(batch_size=4, max_seq_len=16, use_gradcache=gradcache, chunk_size=2)
    trainer = ContrastiveTrainer(model, cfg, SimpleTokenizer(vocab_size=128), tc)
    trainer._opt, trainer._sched = trainer._build_optimizer(1)
    fwd, bwd = [], []

    def hook(module, args, out):
        fwd.append(_flags())
        if out.requires_grad:
            out.register_hook(lambda g: bwd.append(_flags()))

    for layer in model.layers:
        layer.register_forward_hook(hook)
    _set(not TF32[name], not TF32[name])
    loss = trainer._loss_and_grads(trainer._prep_batch(BATCH))
    assert np.isfinite(float(loss))
    want = (TF32[name], TF32[name])
    # layers × towers, × chunks × 2 passes under GradCache (chunks for the backward)
    n_fwd, n_bwd = (2 * 3 * 2 * 2, 2 * 3 * 2) if gradcache else (2 * 3, 2 * 3)
    assert fwd == [want] * n_fwd and bwd == [want] * n_bwd
    assert _flags() == (not TF32[name], not TF32[name])
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)


@pytest.mark.parametrize("dtype_str", [None, "float32", "bfloat16"])
def test_build_model_sets_default_precision_as_jax_does(monkeypatch, dtype_str):
    """`build_model(random_init=True)` gives the JAX CLI's config: dtype
    (bf16 unless asked) and matmul_precision "default". The weight
    initialisers are stubbed on both sides: only the configs are compared."""
    monkeypatch.setattr(jax_models, "init_params", lambda cfg, key: {})
    monkeypatch.setattr(jax_models, "cast_params", lambda params, dtype: params)

    class Stub:
        def __init__(self, cfg, *, device, generator):
            self.cfg = cfg

    monkeypatch.setattr(port_models, "Decoder", Stub)
    kw = {} if dtype_str is None else {"dtype_str": dtype_str}
    _, jcfg, _ = jax_common.build_model("EleutherAI/gpt-neo-125M", random_init=True, **kw)
    model, cfg, _ = port_common.build_model("EleutherAI/gpt-neo-125M", random_init=True,
                                            device="cpu", **kw)
    assert model.cfg is cfg
    assert cfg.matmul_precision == jcfg.matmul_precision == "default"
    assert str(cfg.dtype).split(".")[-1] == np.dtype(jcfg.dtype).name
    assert cfg == from_jax_config(jcfg)


def test_parity_configs_stay_at_highest():
    """The configs the parity tests and the smoke's card-against-CPU checks
    build keep the JAX default, strict float32."""
    for port, jax_cfg in ((tiny("neo"), jax_tiny("neo")), (gpt_neo("125m"), jax_gpt_neo("125m"))):
        assert port.matmul_precision == jax_cfg.matmul_precision == "highest"
        assert from_jax_config(jax_cfg).matmul_precision == "highest"
