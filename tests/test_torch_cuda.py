"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: they skip where torch sees no CUDA card (decided inside each
test, not at import). Imports no JAX, so on a machine with the card and no
JAX they run with:

    python -m pytest tests/test_torch_*.py --noconftest -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sgpt_tpu_torch.ops import short_attention as sa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,Dh,window,alibi,segments", [
    (40, 64, 0, False, False), (77, 64, 16, False, False), (300, 64, 256, True, False),
    (300, 64, 0, False, True), (130, 128, 0, False, False), (33, 16, 8, True, True),
    (90, 48, 0, False, False)])  # Dh 48: bf16 takes the scalar kernel, not the tensor cores
def test_kernel_matches_plain_version(cuda, dtype, atol, T, Dh, window, alibi, segments):
    rng = np.random.default_rng(T + window)
    B, H = 3, 4
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda, dt) for _ in range(3))
    km = np.ones((B, T), np.int32)
    km[-1, T // 3:] = 0
    km = torch.from_numpy(km).to(cuda)
    slopes = torch.from_numpy(rng.random(H).astype(np.float32)).to(cuda)
    seg = torch.from_numpy((np.arange(T) >= T // 2).astype(np.int32)).expand(B, T).to(cuda)
    extra = dict(segments=seg if segments else None,
                 positions=seg * 0 + torch.arange(T, device=cuda) if alibi else None)
    before = sa.launches
    got = sa.short_attention(q, k, v, km, slopes, 0.125, window, H, alibi, **extra)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    want = sa.short_attention_reference(q, k, v, km, slopes, scale=0.125, window=window,
                                        H=H, use_alibi=alibi, **extra)
    assert got.dtype == dt
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=1e-5)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    km = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sa.short_attention(x, x, x, km, None, 1.0, 0, 2, False)
    x = torch.zeros(1, 2049, 16, device=cuda)
    km = torch.ones(1, 2049, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="T=2049"):
        sa.short_attention(x, x, x, km, None, 1.0, 0, 2, False)
