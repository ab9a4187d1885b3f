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
    (90, 48, 0, False, False),  # Dh 48: the scalar kernel, not the tensor cores
    (2048, 64, 256, False, False), (2048, 128, 0, False, True)])  # ALiBi at T=2048: below
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


@pytest.mark.parametrize("Dh,window,segments", [(128, 0, True), (64, 256, False)])
def test_fp32_kernel_with_alibi_at_t2048_is_as_close_to_fp64_as_the_plain_version(
        cuda, Dh, window, segments):
    """ALiBi at key positions up to 2,047 puts fp32 scores near 10^3, where
    an fp32 ulp is 6e-5, so a change in the last bits of q·k can flip the
    rounding of the ALiBi add: the plain version is itself more than 1e-5
    from an fp64 evaluation of the formula, and the tensor-core kernel,
    which sums q·k in another order than the plain version's GEMM, is not
    within 1e-5 of it there. The kernel is held to the exact formula
    instead: no farther from fp64 than the plain version, plus the fp32
    gate's 1e-5."""
    T, H, B, scale = 2048, 4, 3, 0.125
    rng = np.random.default_rng(T + window)
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda) for _ in range(3))
    km = np.ones((B, T), np.int32)
    km[-1, T // 3:] = 0
    km = torch.from_numpy(km).to(cuda)
    slopes = torch.from_numpy(rng.random(H).astype(np.float32)).to(cuda)
    seg = torch.from_numpy((np.arange(T) >= T // 2).astype(np.int32)).expand(B, T).to(cuda)
    pos = seg * 0 + torch.arange(T, device=cuda)
    kw = dict(scale=scale, window=window, H=H, use_alibi=True,
              segments=seg if segments else None, positions=pos)
    got = sa.short_attention(q, k, v, km, slopes, scale, window, H, True,
                             segments=kw["segments"], positions=pos)
    want = sa.short_attention_reference(q, k, v, km, slopes, **kw)
    _, mask = sa._scores(q, k, km, slopes, **kw)
    qd, kd, vd = (t.reshape(B, T, H, Dh).double() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    s = s + slopes.double()[None, :, None, None] * pos.double()[:, None, None, :]
    s = torch.where(mask, s, torch.full((), -1e9, dtype=torch.float64, device=cuda))
    exact = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd).reshape(B, T, H * Dh)
    plain_err = (want.double() - exact).abs().max().item()
    assert plain_err > 1e-5  # the case is as ill-conditioned as the note says
    assert (got.double() - exact).abs().max().item() <= plain_err + 1e-5


def test_fp32_kernel_off_16_byte_alignment_matches_plain_version(cuda):
    """fp32 tensors at a storage offset of one element are not 16-byte
    aligned, so K1 takes its scalar kernel rather than the tensor-core one;
    the output holds the same fp32 gate."""
    rng = np.random.default_rng(11)
    B, T, H, Dh = 2, 150, 4, 64
    n = B * T * H * Dh
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, n + 1).astype(np.float32)).to(cuda)[1:]
               .view(B, T, H * Dh) for _ in range(3))
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    km = torch.ones(B, T, dtype=torch.int32, device=cuda)
    km[-1, 100:] = 0
    before = sa.launches
    got = sa.short_attention(q, k, v, km, None, 1.0, 16, H, False)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    want = sa.short_attention_reference(q, k, v, km, None, scale=1.0, window=16, H=H,
                                        use_alibi=False)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_fp32_kernel_row_does_not_depend_on_the_batch(cuda):
    """A row's fp32 output is the same bits whether its batch row runs alone
    (B=1) or among 32: GradCache's chunks and the direct step see one value."""
    rng = np.random.default_rng(12)
    B, T, H, Dh = 32, 300, 12, 64
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32)).to(cuda)
               for _ in range(3))
    km = np.ones((B, T), np.int32)
    km[::3, 200:] = 0
    km = torch.from_numpy(km).to(cuda)
    for window in (0, 256):
        full = sa.short_attention(q, k, v, km, None, 1.0, window, H, False)
        for b in (0, 1, 31):
            one = sa.short_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], km[b:b + 1], None,
                                     1.0, window, H, False)
            assert torch.equal(one[0], full[b]), (window, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    km = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sa.short_attention(x, x, x, km, None, 1.0, 0, 2, False)
    x = torch.zeros(1, 2049, 16, device=cuda)
    km = torch.ones(1, 2049, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="T=2049"):
        sa.short_attention(x, x, x, km, None, 1.0, 0, 2, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,Dh,window,alibi,segments", [
    (40, 64, 0, False, False), (77, 64, 16, False, False), (300, 64, 256, True, False),
    (300, 64, 0, False, True), (130, 128, 0, False, False), (33, 16, 8, True, True),
    (100, 32, 16, False, False), (90, 48, 0, False, False)])
def test_backward_kernel_matches_plain_version(cuda, dtype, T, Dh, window, alibi, segments):
    """K2 == `short_attention_bwd_reference`. fp32: |Δ| ≤ 1e-5·max|ref| +
    1e-5·|ref| (summation order only); bf16: 2e-2 + 1e-2·|ref| (a flipped
    rounding of P or of an output)."""
    rng = np.random.default_rng(T + window + 1)
    B, H = 3, 4
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                  .to(cuda, dt) for _ in range(4))
    km = np.ones((B, T), np.int32)
    km[-1, T // 3:] = 0
    km = torch.from_numpy(km).to(cuda)
    slopes = torch.from_numpy(rng.random(H).astype(np.float32)).to(cuda)
    seg = torch.from_numpy((np.arange(T) >= T // 2).astype(np.int32)).expand(B, T).to(cuda)
    extra = dict(segments=seg if segments else None,
                 positions=seg * 0 + torch.arange(T, device=cuda) if alibi else None)
    kw = dict(scale=0.125, window=window, H=H, use_alibi=alibi, **extra)
    before = sa.bwd_launches
    got = sa.short_attention_bwd(q, k, v, km, slopes, g, **kw)
    torch.cuda.synchronize()
    assert sa.bwd_launches == before + 1
    want = sa.short_attention_bwd_reference(q, k, v, km, slopes, g, **kw)
    for gg, ww in zip(got, want):
        assert gg.dtype == dt
        gg, ww = gg.float(), ww.float()
        atol = 1e-5 * ww.abs().max().item() if dtype == "float32" else 2e-2
        rtol = 1e-5 if dtype == "float32" else 1e-2
        assert ((gg - ww).abs() <= atol + rtol * ww.abs()).all()


def _bwd_inputs(rng, B, T, H, Dh, device, lengths=None):
    q, k, v, g = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                  .to(device) for _ in range(4))
    km = np.ones((B, T), np.int32)
    if lengths is None:
        km[-1, T // 3:] = 0
    else:
        km = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, torch.from_numpy(km).to(device), g


def _check_bwd_gate(got, want):
    """K2's fp32 gate: |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| in dq, dk and dv."""
    for gg, ww in zip(got, want):
        atol = 1e-5 * ww.abs().max().item()
        assert ((gg - ww).abs() <= atol + 1e-5 * ww.abs()).all()


def _bf16_grad_gate(got, want):
    """bf16's gate of a gradient against its plain version, scaled to the
    tensor (as chip_smoke.py's `bf16_grad_gate`): |Δ| ≤ 1e-2·|ref| +
    min(2e-2, 1e-2·RMS(ref)) everywhere and ‖Δ‖ ≤ 1e-2·‖ref‖. Both sides sum
    in fp32 and round once to bf16, so a sound kernel differs by flipped
    roundings; a fixed 2e-2 alone would pass a zeroed tile of gradients that
    are ~5e-3 at T=2048."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    atol = min(2e-2, 1e-2 * w.pow(2).mean().sqrt().item())
    assert (err <= atol + 1e-2 * w.abs()).all(), (err - 1e-2 * w.abs()).max().item()
    assert err.norm() <= 1e-2 * w.norm(), (err.norm() / w.norm()).item()


def _bwd_kernel_names(fn):
    return _kernel_names(fn, ("tf32_rows", "tf32_cols", "rows_kernel", "cols_kernel"))[0]


@pytest.mark.parametrize("Dh,offset,pair", [
    (16, 0, True), (32, 0, True), (64, 0, True), (128, 0, True), (256, 0, True),
    (48, 0, False),  # a head size the tensor-core pair does not take
    (64, 1, False),  # tensors one element off 16-byte alignment
    (256, 1, False)])
def test_fp32_backward_routing_and_gate(cuda, Dh, offset, pair):
    """fp32 K2 takes the 3xTF32 pair (`tf32_rows`, `tf32_cols`) at head
    sizes 16, 32, 64 and 128 and `tf32_rows_wide`, `tf32_cols_wide` at 256
    (GPT-J), with 16-byte-aligned tensors, and the CUDA-core
    `rows_kernel`/`cols_kernel` otherwise; all hold the fp32 gate."""
    rng = np.random.default_rng(Dh + offset)
    B, T, H = 3, 150, 4
    n = B * T * H * Dh
    q, k, v, g = (torch.from_numpy(rng.normal(0, 0.5, n + offset).astype(np.float32))
                  .to(cuda)[offset:].view(B, T, H * Dh) for _ in range(4))
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    km = torch.ones(B, T, dtype=torch.int32, device=cuda)
    km[-1, 100:] = 0
    kw = dict(scale=0.125, window=16, H=H, use_alibi=False)
    names = _bwd_kernel_names(lambda: sa.short_attention_bwd(q, k, v, km, None, g, **kw))
    assert names and all(("tf32_" in n) == pair for n in names), names
    assert all(("_wide" in n) == (pair and Dh == 256) for n in names), names
    _check_bwd_gate(sa.short_attention_bwd(q, k, v, km, None, g, **kw),
                    sa.short_attention_bwd_reference(q, k, v, km, None, g, **kw))


def test_fp32_backward_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits (no atomics):
    GradCache's check against the direct step depends on it."""
    rng = np.random.default_rng(13)
    q, k, v, km, g = _bwd_inputs(rng, 32, 300, 12, 64, cuda)
    for window in (0, 256):
        kw = dict(scale=1.0, window=window, H=12, use_alibi=False)
        a = sa.short_attention_bwd(q, k, v, km, None, g, **kw)
        b = sa.short_attention_bwd(q, k, v, km, None, g, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), window


def test_fp32_backward_at_the_msmarco_query_tower(cuda):
    """The query tower of MS MARCO training: 3-11-word queries padded to
    T=300, B=32, H=12, Dh=64, in a window-256 layer. Rows from a query's
    length + 255 on have no valid key: dQ is 0 there, and their g/T reaches
    dV of every key, the padded ones included."""
    rng = np.random.default_rng(14)
    B, T, H, window = 32, 300, 12, 256
    lengths = rng.integers(5, 14, B)
    q, k, v, km, g = _bwd_inputs(rng, B, T, H, 64, cuda, lengths)
    kw = dict(scale=1.0, window=window, H=H, use_alibi=False)
    got = sa.short_attention_bwd(q, k, v, km, None, g, **kw)
    _check_bwd_gate(got, sa.short_attention_bwd_reference(q, k, v, km, None, g, **kw))
    dq, _, dv = got
    for b, n in enumerate(lengths):
        dead = int(n) + window - 1
        assert torch.all(dq[b, dead:] == 0)
        want = (g[b, dead:].sum(0) / T).expand(T - int(n), -1)
        torch.testing.assert_close(dv[b, int(n):], want, atol=1e-5, rtol=1e-5)


def test_autograd_on_the_card_launches_the_backward_kernel(cuda):
    rng = np.random.default_rng(0)
    B, T, H, Dh = 2, 50, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda).requires_grad_() for _ in range(3))
    km = torch.ones(B, T, dtype=torch.int32, device=cuda)
    launches, bwd = sa.launches, sa.bwd_launches
    out = sa.short_attention(q, k, v, km, None, 1.0, 16, H, False)
    assert out.grad_fn is not None and sa.launches == launches + 1
    g = torch.from_numpy(rng.normal(size=(B, T, H * Dh)).astype(np.float32)).to(cuda)
    out.backward(g.mT.contiguous().mT)  # a non-contiguous gradient
    assert sa.bwd_launches == bwd + 1
    want = sa.short_attention_bwd_reference(q.detach(), k.detach(), v.detach(), km, None, g,
                                            scale=1.0, window=16, H=H, use_alibi=False)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert sa.short_attention(q, k, v, km, None, 1.0, 16, H, False).grad_fn is None
    assert sa.bwd_launches == bwd + 1


def test_backward_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 16, device=cuda, dtype=torch.float16)
    km = torch.ones(1, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sa.short_attention_bwd(x, x, x, km, None, x, scale=1.0, window=0, H=2,
                               use_alibi=False)
    x = torch.zeros(1, 2049, 16, device=cuda)
    km = torch.ones(1, 2049, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="T=2049"):
        sa.short_attention_bwd(x, x, x, km, None, x, scale=1.0, window=0, H=2,
                               use_alibi=False)


def test_train_step_on_the_card_equals_the_cpu_step(cuda):
    """One BitFit step of a 2-layer model at GPT-Neo-125M's width: the card
    (K1, K2) against the CPU (plain versions), same weights and batch. Loss
    within 1e-5 relative; each bias gradient within 1e-4 of its leaf's norm
    (fp32 on both; cuBLAS and the kernels sum in another order)."""
    import copy

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig

    cfg = gpt_neo("125m").replace(num_layers=2)
    cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    tok = SimpleTokenizer(cfg.vocab_size)
    tc = TrainConfig(lr=2e-4, batch_size=4, max_seq_len=64, specb=True,
                     freeze_nonbias=True)
    batch = [(f"query {i} about topic {i % 3}", f"document {i} " + "words " * (10 + 9 * i),
              f"other document {i + 5} " + "text " * (20 + 5 * i)) for i in range(4)]
    results = []
    for model in (cpu, gpu):
        trainer = ContrastiveTrainer(model, cfg, tok, tc)
        trainer._opt, trainer._sched = trainer._build_optimizer(1)
        bwd = sa.bwd_launches
        loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
        if model is gpu:
            assert sa.bwd_launches == bwd + cfg.num_layers * 3
        results.append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()
                               if p.requires_grad}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert g_cpu and set(g_cpu) == set(g_gpu)
    for name, want in g_cpu.items():
        tol = 1e-4 * max(want.norm().item(), 1e-12)
        assert (g_gpu[name] - want).abs().max().item() <= tol, name


def _unit(rng, n, d, device, dtype):
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(device, dtype)


def _check_mips(q, c, got, want):
    """K5 against `mips_topk_reference`: values within 1e-5 (unit-norm rows;
    the sums run in another order) and ids equal in every slot above -1e29,
    except where two candidates' plain scores lie within 1e-5 of each other:
    there the kernel's ids, scored by the plain version, lie within 1e-5 of
    the plain top-k."""
    (gv, gi), (wv, wi) = got, want
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32
    assert (gv - wv).abs().max().item() <= 1e-5
    real = wv > -1e29
    assert torch.equal(gv > -1e29, real)
    assert (gi[~real] == 0).all()
    diff = real & (gi != wi)
    if diff.any():
        rescored = torch.einsum("qd,qkd->qk", q.float(), c[gi.long()].float())
        assert ((rescored - wv).abs()[diff] <= 1e-5).all(), "ids differ away from a near-tie"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("Q,N,D,k,valid,dup", [
    (64, 20_011, 768, 10, None, False), (1, 5000, 768, 1, None, False),
    (300, 9000, 768, 16, None, False), (16, 3000, 2560, 10, None, False),
    (8, 4096, 768, 10, 3001, False), (4, 4096, 768, 10, 5, False),
    (5, 4096, 768, 10, None, True), (7, 3000, 100, 5, None, False)])
def test_mips_kernel_matches_plain_version(cuda, dtype, Q, N, D, k, valid, dup):
    from sgpt_tpu_torch.ops import mips

    rng = np.random.default_rng(N + k)
    dt = getattr(torch, dtype)
    c = _unit(rng, N, D, cuda, dt)
    q = _unit(rng, Q, D, cuda, dt)
    if dup:  # exact ties: copied rows, and a query equal to one of them
        c[N // 2: N // 2 + 40] = c[10:50].clone()
        q[0] = c[10]
    valid = N if valid is None else valid
    c[valid:] = 10.0  # rows past valid_count must be invisible
    before = mips.launches
    got = mips.mips_topk(q, c, valid, k)
    torch.cuda.synchronize()
    assert mips.launches == before + 1
    _check_mips(q, c, got, mips.mips_topk_reference(q, c, valid, k))
    if dup:
        assert got[1][0, :2].tolist() == [10, N // 2]


def test_mips_kernel_rejects_what_it_does_not_take(cuda):
    from sgpt_tpu_torch.ops import mips

    q = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError, match="k=17"):
        mips.mips_topk(q, torch.zeros(100, 64, device=cuda), 100, 17)
    with pytest.raises(TypeError):
        mips.mips_topk(q, torch.zeros(100, 64, device=cuda, dtype=torch.bfloat16), 100, 5)
    with pytest.raises(ValueError):
        mips.mips_topk(q, torch.zeros(100, 32, device=cuda), 100, 5)


def test_cuda_index_launches_the_mips_kernel_per_search(cuda):
    """DenseIndex on the card with kernel="pallas": one K5 launch per search
    dispatch (the pending slab goes through blockmax_topk), and the same ids
    as the block-max index."""
    from sgpt_tpu_torch.index import DenseIndex
    from sgpt_tpu_torch.ops import mips

    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(5000, 768)).astype(np.float32)
    queries = rng.normal(size=(32, 768)).astype(np.float32)
    idx = {}
    for kernel in ("pallas", "blockmax"):
        idx[kernel] = DenseIndex(768, kernel=kernel, device=cuda)
        idx[kernel].add(corpus[:4000])
        idx[kernel].build()
        idx[kernel].add(corpus[4000:])
    before = mips.launches
    va, ia = idx["pallas"].search_embeddings(queries, k=10)
    vb, ib = idx["pallas"].search_embeddings(queries[:3], k=16)
    assert mips.launches == before + 2
    vc, ic = idx["blockmax"].search_embeddings(queries, k=10)
    assert mips.launches == before + 2
    assert ia == ic
    np.testing.assert_allclose(np.stack(va), np.stack(vc), atol=1e-5)


FLASH_CASES = [  # T, Dh, block_kv, window, scale, alibi, projection-layout views
    (128, 64, 128, 0, 1.0, False, False), (256, 64, 256, 256, 1.0, False, True),
    (512, 64, 256, 0, 0.125, True, True), (512, 16, 128, 64, 1.0, True, False),
    (384, 32, 128, 256, 0.125, False, False), (1024, 128, 256, 256, 1.0, False, True),
    (2048, 64, 256, 256, 1.0, False, True)]


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("T,Dh,block_kv,window,scale,alibi,views", FLASH_CASES)
def test_flash_kernel_matches_plain_version(cuda, dtype, atol, T, Dh, block_kv, window,
                                            scale, alibi, views):
    """K3 == `flash_attention_reference`, output and lse on every row: a
    short row leaves fully masked rows under a window, and a fully padded
    batch row masks every key. fp32: summation order only; bf16: a flipped
    rounding of P or of the output."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(T + Dh + window)
    B, H = 3, 4
    dt = getattr(torch, dtype)
    if views:  # the decoder's (B, T, H·Dh) projections seen as (B, H, T, Dh)
        q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                   .to(cuda, dt).view(B, T, H, Dh).transpose(1, 2) for _ in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, H, T, Dh)).astype(np.float32))
                   .to(cuda, dt) for _ in range(3))
    km = torch.from_numpy((np.arange(T)[None] < np.array([[20], [0], [T - 37]]))
                          .astype(np.int32)).to(cuda)
    slopes = torch.from_numpy((0.03 * rng.random(H)).astype(np.float32)).to(cuda)
    kw = dict(scale=scale, window=window, block_kv=block_kv)
    before = fa.launches
    got, lse = fa.flash_attention(q, k, v, km, slopes if alibi else None,
                                  return_residuals=True, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.dtype == dt and got.stride() == q.stride()
    want, want_lse = fa.flash_attention_reference(q, k, v, km, slopes if alibi else None, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=0)


def _flash_fp32_inputs(rng, B, H, T, Dh, cuda):
    """fp32 projections seen as (B, H, T, Dh), a key mask with a short row
    (fully masked rows under a window) and a fully padded one, BLOOM-sized
    slopes."""
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda).view(B, T, H, Dh).transpose(1, 2) for _ in range(3))
    lengths = np.array([[20], [0], [T - 37]])[:B]
    km = torch.from_numpy((np.arange(T)[None] < lengths).astype(np.int32)).to(cuda)
    slopes = torch.from_numpy((0.03 * rng.random(H)).astype(np.float32)).to(cuda)
    return q, k, v, km, slopes


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_flash_fp32_launches_the_3xtf32_kernel(cuda, Dh):
    """fp32 K3 is `flash_fwd_tf32` at every head size it takes (the CUDA-core
    `flash_fwd_f32` is gone), named so by the profiler, and holds the fp32
    gate |Δ| ≤ 1e-5 + 1e-5·|ref| of the plain version in output and lse."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    q, k, v, km, slopes = _flash_fp32_inputs(np.random.default_rng(Dh), 3, 4, 512, Dh, cuda)
    kw = dict(scale=0.125, window=64, block_kv=128)
    names, (got, lse) = _kernel_names(
        lambda: fa.flash_attention(q, k, v, km, slopes, return_residuals=True, **kw),
        ("flash_fwd",))
    assert names and all("flash_fwd_tf32" in n for n in names), names
    want, want_lse = fa.flash_attention_reference(q, k, v, km, slopes, **kw)
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()
    dead = want_lse == fa.NEG_INF
    assert torch.equal(lse == fa.NEG_INF, dead) and dead.any()
    assert ((lse - want_lse).abs()[~dead] <= 1e-5 + 1e-5 * want_lse.abs()[~dead]).all()


def test_flash_fp32_is_deterministic(cuda):
    """Two launches on the same inputs give the same bits (no atomics):
    GradCache runs the forward twice a chunk and checks against the direct
    step."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    q, k, v, km, _ = _flash_fp32_inputs(np.random.default_rng(21), 3, 12, 2048, 64, cuda)
    for window in (0, 256):
        a = fa.flash_attention(q, k, v, km, window=window, block_kv=256, return_residuals=True)
        b = fa.flash_attention(q, k, v, km, window=window, block_kv=256, return_residuals=True)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), window


def test_flash_fp32_with_alibi_at_t2048_is_as_close_to_fp64_as_the_plain_version(cuda):
    """Dh 128 (GPT-Neo 1.3B/2.7B heads) at T=2048 with ALiBi at key
    positions up to 2,047: on the rows that hold a valid key, K3's fp32
    output (3xTF32 products) is no further from an fp64 evaluation of the
    formula than twice the plain version's distance from it."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    T, Dh, window = 2048, 128, 256
    q, k, v, km, slopes = _flash_fp32_inputs(np.random.default_rng(22), 3, 4, T, Dh, cuda)
    kw = dict(window=window, block_kv=256)
    got = fa.flash_attention(q, k, v, km, slopes, **kw)
    want, _ = fa.flash_attention_reference(q, k, v, km, slopes, **kw)
    i = torch.arange(T, device=cuda)
    mask = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))[None, None] \
        & (km > 0)[:, None, None, :]
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double())
    s = s + slopes.double()[None, :, None, None] * i.double()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1).nan_to_num(0.0)
    exact = torch.einsum("bhqk,bhkd->bhqd", p, v.double())
    valid = mask.any(-1, keepdim=True)
    kernel_err = torch.where(valid, (got.double() - exact).abs(), 0.0).max().item()
    plain_err = torch.where(valid, (want.double() - exact).abs(), 0.0).max().item()
    assert kernel_err <= 2 * plain_err, (kernel_err, plain_err)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    from sgpt_tpu_torch.ops import flash_attention as fa

    km = torch.ones(1, 256, dtype=torch.int32, device=cuda)
    x = torch.zeros(1, 2, 256, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(x, x, x, km)
    x = torch.zeros(1, 2, 256, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(x, x, x, km)
    x = torch.zeros(1, 2, 256, 64, device=cuda)
    with pytest.raises(ValueError, match="64-row"):
        fa.flash_attention(x, x, x, km, block_q=32, block_kv=32)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(x[:, :, :200], x[:, :, :200], x[:, :, :200], km[:, :200])
    lse = torch.zeros(1, 2, 256, device=cuda)
    with pytest.raises(ValueError, match="differs from q"):  # g in another dtype
        fa.flash_attention_bwd(x, x, x, km, None, x.bfloat16(), x, lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(x, x, x, km, None, x, x, lse[:, :, :128])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,Dh,block_kv,window,scale,alibi,views", FLASH_CASES)
def test_flash_backward_kernels_match_plain_version(cuda, dtype, T, Dh, block_kv, window,
                                                    scale, alibi, views):
    """K4a/K4b == `flash_attention_bwd_reference` from the forward's own
    residuals (a short row leaves fully masked rows under a window, and a
    fully padded batch row masks every key; their dq is exactly 0). fp32
    (`flash_bwd_dq_tf32`, `flash_bwd_dkv_tf32`: 3xTF32): |Δ| ≤
    1e-5·max|ref| + 1e-5·|ref|; bf16 (the CUDA-core kernels): 2e-2 +
    1e-2·|ref| (a flipped rounding of an output cast to bf16)."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(T + Dh + window + 1)
    B, H = 3, 4
    dt = getattr(torch, dtype)

    def t(std):
        if views:  # the decoder's (B, T, H·Dh) projections seen as (B, H, T, Dh)
            x = torch.from_numpy(rng.normal(0, std, (B, T, H * Dh)).astype(np.float32))
            return x.to(cuda, dt).view(B, T, H, Dh).transpose(1, 2)
        return torch.from_numpy(rng.normal(0, std, (B, H, T, Dh)).astype(np.float32)).to(cuda, dt)

    q, k, v, g = t(0.5), t(0.5), t(0.5), t(1.0)
    km = torch.from_numpy((np.arange(T)[None] < np.array([[20], [0], [T - 37]]))
                          .astype(np.int32)).to(cuda)
    slopes = torch.from_numpy((0.03 * rng.random(H)).astype(np.float32)).to(cuda)
    kw = dict(scale=scale, window=window, block_kv=block_kv)
    sl = slopes if alibi else None
    out, lse = fa.flash_attention(q, k, v, km, sl, return_residuals=True, **kw)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, km, sl, g, out, lse, **kw)
    torch.cuda.synchronize()
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_bwd_reference(q, k, v, km, sl, g, out, lse, **kw)
    dead = lse == fa.NEG_INF
    assert dead[1].all() and (got[0][dead] == 0).all()
    for gg, ww in zip(got, want):
        assert gg.dtype == dt and gg.stride() == q.stride()
        gg, ww = gg.float(), ww.float()
        atol = 1e-5 * ww.abs().max().item() if dtype == "float32" else 2e-2
        rtol = 1e-5 if dtype == "float32" else 1e-2
        assert ((gg - ww).abs() <= atol + rtol * ww.abs()).all()


def test_flash_train_step_on_the_card_equals_the_cpu_step(cuda):
    """One BitFit step of a 2-layer use_flash model at GPT-Neo-125M's width,
    max_seq_len 256: every layer of every tower launches K3, K4a and K4b once
    (K1 and K2 never), and the loss and bias gradients equal the CPU's
    (plain versions): loss within 1e-5 relative, each gradient within 1e-4
    of its leaf's norm."""
    import copy

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig

    cfg = gpt_neo("125m", use_flash=True).replace(num_layers=2)
    cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    tok = SimpleTokenizer(cfg.vocab_size)
    tc = TrainConfig(lr=2e-4, batch_size=3, max_seq_len=256, specb=True, freeze_nonbias=True)
    batch = [(f"query {i} about topic {i % 3}", f"document {i} " + "words " * (40 + 90 * i),
              f"other document {i + 5} " + "text " * (20 + 60 * i)) for i in range(3)]
    results = []
    for model in (cpu, gpu):
        trainer = ContrastiveTrainer(model, cfg, tok, tc)
        trainer._opt, trainer._sched = trainer._build_optimizer(1)
        counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches, sa.launches,
                  sa.bwd_launches)
        loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
        n = cfg.num_layers * 3 if model is gpu else 0
        assert (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches, sa.launches,
                sa.bwd_launches) == (counts[0] + n, counts[1] + n, counts[2] + n, counts[3],
                                     counts[4])
        results.append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()
                               if p.requires_grad}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert g_cpu and set(g_cpu) == set(g_gpu)
    for name, want in g_cpu.items():
        tol = 1e-4 * max(want.norm().item(), 1e-12)
        assert (g_gpu[name] - want).abs().max().item() <= tol, name


def _fbwd_fp32_args(rng, B, H, T, Dh, cuda, window, alibi=False, scale=1.0):
    """q, k, v and a cotangent g as the decoder's projection views, the
    forward's residuals (K3 at `scale`) and K4's arguments, with a short row
    (fully masked rows under a window) and a fully padded one."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    q, k, v, km, slopes = _flash_fp32_inputs(rng, B, H, T, Dh, cuda)
    g = torch.from_numpy(rng.normal(0, 1, (B, T, H * Dh)).astype(np.float32)).to(cuda).view(
        B, T, H, Dh).transpose(1, 2)
    sl = slopes if alibi else None
    kw = dict(window=window, block_kv=256)
    out, lse = fa.flash_attention(q, k, v, km, sl, return_residuals=True, scale=scale, **kw)
    return (q, k, v, km, sl, g, out, lse), kw


@pytest.mark.parametrize("Dh,dtype", [(16, "float32"), (32, "float32"), (64, "float32"),
                                      (128, "float32"), (64, "bfloat16")])
def test_flash_backward_dkv_routing(cuda, Dh, dtype):
    """K4b in fp32 is `flash_bwd_dkv_tf32` (3xTF32 on the tensor cores) at
    every head size below 256 (there `flash_bwd_dkv_wide`, held by
    test_k3_at_head_size_256_launches_its_templates), and in bf16 the
    CUDA-core `flash_bwd_dkv`, named so by the profiler; both hold K4's gate
    against the plain version."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    (q, k, v, km, sl, g, out, lse), kw = _fbwd_fp32_args(np.random.default_rng(Dh), 3, 4, 512,
                                                         Dh, cuda, 64, alibi=True)
    dt = getattr(torch, dtype)
    q, k, v, g, out = (t.to(dt) for t in (q, k, v, g, out))
    names, got = _kernel_names(
        lambda: fa.flash_attention_bwd(q, k, v, km, sl, g, out, lse, scale=0.125, **kw),
        ("flash_bwd_dkv",))
    assert names and all(("flash_bwd_dkv_tf32" in n) == (dtype == "float32") for n in names), \
        names
    want = fa.flash_attention_bwd_reference(q, k, v, km, sl, g, out, lse, scale=0.125, **kw)
    for gg, ww in zip(got[1:], want[1:]):
        gg, ww = gg.float(), ww.float()
        atol = 1e-5 * ww.abs().max().item() if dtype == "float32" else 2e-2
        rtol = 1e-5 if dtype == "float32" else 1e-2
        assert ((gg - ww).abs() <= atol + rtol * ww.abs()).all()


@pytest.mark.parametrize("Dh,dtype", [(16, "float32"), (32, "float32"), (64, "float32"),
                                      (128, "float32"), (64, "bfloat16")])
def test_flash_backward_dq_routing(cuda, Dh, dtype):
    """K4a in fp32 is `flash_bwd_dq_tf32` (3xTF32 on the tensor cores) at
    every head size below 256 (there `flash_bwd_dq_wide`), and in bf16 the
    CUDA-core `flash_bwd_dq`, named so by the profiler; dq holds K4's gate
    against the plain version, from the residuals of a forward at the
    backward's scale (as training has them: p ≤ 1)."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    (q, k, v, km, sl, g, out, lse), kw = _fbwd_fp32_args(np.random.default_rng(Dh + 1), 3, 4,
                                                         512, Dh, cuda, 64, alibi=True,
                                                         scale=0.125)
    dt = getattr(torch, dtype)
    q, k, v, g, out = (t.to(dt) for t in (q, k, v, g, out))
    names, got = _kernel_names(
        lambda: fa.flash_attention_bwd(q, k, v, km, sl, g, out, lse, scale=0.125, **kw),
        ("flash_bwd_dq",))
    assert names and all(("flash_bwd_dq_tf32" in n) == (dtype == "float32") for n in names), \
        names
    want = fa.flash_attention_bwd_reference(q, k, v, km, sl, g, out, lse, scale=0.125, **kw)
    gg, ww = got[0].float(), want[0].float()
    atol = 1e-5 * ww.abs().max().item() if dtype == "float32" else 2e-2
    rtol = 1e-5 if dtype == "float32" else 1e-2
    assert ((gg - ww).abs() <= atol + rtol * ww.abs()).all()


def test_flash_fp32_backward_is_deterministic(cuda):
    """Two launches of K4 (K4a's dq and D, K4b's dk and dv) on the same
    inputs give the same bits (no atomics): GradCache's check against the
    direct step depends on it."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    for window in (0, 256):
        args, kw = _fbwd_fp32_args(np.random.default_rng(23), 3, 12, 2048, 64, cuda, window)
        a = fa.flash_attention_bwd(*args, **kw)
        b = fa.flash_attention_bwd(*args, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), window


def test_flash_fp32_backward_with_alibi_at_t2048_is_as_close_to_fp64_as_the_plain_version(
        cuda):
    """Dh 128 at T=2048 with ALiBi (slopes ≤ 0.03) and window 256: K4a's dq
    and K4b's dk and dv (3xTF32 products) are no further from an fp64
    evaluation of the formula, from the same lse, than twice the plain
    version's distance."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    T, Dh, window = 2048, 128, 256
    args, kw = _fbwd_fp32_args(np.random.default_rng(24), 3, 4, T, Dh, cuda, window,
                               alibi=True)
    q, k, v, km, sl, g, out, lse = args
    got = fa.flash_attention_bwd(*args, **kw)
    want = fa.flash_attention_bwd_reference(*args, **kw)
    i = torch.arange(T, device=cuda)
    mask = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window))[None, None] \
        & (km > 0)[:, None, None, :]
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) + sl.double()[None, :, None, None] * i.double()
    p = torch.where(mask, torch.exp(s - lse.double()[..., None]), 0.0)
    dsum = (gd * out.double()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gd, vd) - dsum)
    exact = (torch.einsum("bhqk,bhkd->bhqd", ds, kd), torch.einsum("bhqk,bhqd->bhkd", ds, qd),
             torch.einsum("bhqk,bhqd->bhkd", p, gd))
    for name, a, b, e in zip(("dq", "dk", "dv"), got, want, exact):
        kernel_err = (a.double() - e).abs().max().item()
        plain_err = (b.double() - e).abs().max().item()
        assert kernel_err <= 2 * plain_err, (name, kernel_err, plain_err)


def test_flash_train_step_with_local_layers_runs_k4b_tf32_and_equals_the_cpu_step(cuda):
    """One BitFit step of a 2-layer use_flash model at GPT-Neo-125M's width
    (a global and a window-256 layer), max_seq_len 512: K4b runs as
    `flash_bwd_dkv_tf32` alone and K4a as `flash_bwd_dq_tf32` alone, once a
    layer and tower, and the loss and
    bias gradients equal the CPU's (plain versions): loss within 1e-5
    relative, each gradient within 1e-4 of its leaf's norm."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig

    cfg = gpt_neo("125m", use_flash=True).replace(num_layers=2)
    cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    gpu = copy.deepcopy(cpu).to(cuda)
    tok = SimpleTokenizer(cfg.vocab_size)
    tc = TrainConfig(lr=2e-4, batch_size=3, max_seq_len=512, specb=True, freeze_nonbias=True)
    batch = [(f"query {i} on subject {i % 2}", f"passage {i} " + "words " * (100 + 150 * i),
              f"unrelated passage {i + 7} " + "text " * (60 + 120 * i)) for i in range(3)]
    results = []
    for model in (cpu, gpu):
        trainer = ContrastiveTrainer(model, cfg, tok, tc)
        trainer._opt, trainer._sched = trainer._build_optimizer(1)
        before = fa.bwd_dkv_launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
        assert fa.bwd_dkv_launches - before == (cfg.num_layers * 3 if model is gpu else 0)
        if model is gpu:
            for family in ("flash_bwd_dkv", "flash_bwd_dq"):
                names = {ev.key for ev in prof.key_averages() if family in ev.key}
                assert names and all(f"{family}_tf32" in n for n in names), names
        results.append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()
                               if p.requires_grad}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert g_cpu and set(g_cpu) == set(g_gpu)
    for name, want in g_cpu.items():
        tol = 1e-4 * max(want.norm().item(), 1e-12)
        assert (g_gpu[name] - want).abs().max().item() <= tol, name


def test_flash_engine_on_the_card_launches_k3_and_equals_the_cpu(cuda):
    """A 2-layer model at GPT-Neo-125M's width with use_flash, fp32: batches
    at T % 128 == 0 run K3 in every layer, the others K1, and the card's
    embeddings equal the CPU's (plain versions) within 1e-4."""
    import copy

    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    cfg = gpt_neo("125m", use_flash=True).replace(num_layers=2)
    cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    texts = [" ".join(f"w{rng.integers(0, 9000)}" for _ in range(n))
             for n in (5, 40, 100, 200, 250, 400, 600)]  # buckets 16, 64, 128, 256, 512
    kw = dict(specb=True, max_seq_len=512, batch_size=2, normalize_embeddings=True)
    tok = SimpleTokenizer(cfg.vocab_size)
    want = EmbeddingEngine(cpu, cfg, tok, device="cpu", **kw).encode(texts)
    engine = EmbeddingEngine(gpu, cfg, tok, device=cuda, **kw)
    shapes = []
    hook = gpu.register_forward_pre_hook(lambda m, a: shapes.append(a[0].shape[1]))
    k3, k1 = fa.launches, sa.launches
    got = engine.encode(texts)
    hook.remove()
    flash = sum(T % 128 == 0 for T in shapes)
    assert 0 < flash < len(shapes)
    assert fa.launches - k3 == cfg.num_layers * flash
    assert sa.launches - k1 == cfg.num_layers * (len(shapes) - flash)
    np.testing.assert_allclose(got, want, atol=1e-4)


# The K5 scan's hazards stand last. Run between two CUDA-only
# torch.profiler sessions of one process (all twelve; any one alone did
# not), they left the later sessions without kernel events on the card's
# machine, so the profiler-based routing tests above keep the place in the
# file they had.
PROFILER_SESSIONS = 3


def _port_launches():
    """The launches that the port's wrappers have counted, K1 to K5 together."""
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.ops import mips

    return (sa.launches + sa.bwd_launches + fa.launches + fa.bwd_dq_launches
            + fa.bwd_dkv_launches + mips.launches)


def _kernel_names(fn, keys):
    """The device kernels whose names hold one of `keys` that fn() launched,
    by the profiler (the wrappers' own dtype casts launch PyTorch kernels
    too), and fn()'s result. A CUDA profiler session on the card's machine
    has come back now and then with no kernel event, or with PyTorch's
    kernels but not the port's (seen in runs of a subset of this file):
    only when no event holds one of `keys` is fn() profiled again (it must
    give the same result each call), up to PROFILER_SESSIONS sessions; the
    caller's check of the names stands either way. Every session, the ones
    that found no name included, must raise the wrappers' launch counts: a
    call that launched no kernel of the port fails here whatever the
    profiler saw."""
    from torch.profiler import ProfilerActivity, profile

    for session in range(PROFILER_SESSIONS):
        before = _port_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        assert _port_launches() > before, f"session {session}: no kernel of the port launched"
        names = {ev.key for ev in prof.key_averages()
                 if str(getattr(ev, "device_type", "")).endswith("CUDA")
                 and any(k in ev.key for k in keys)}
        if names:
            break
    return names, out


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("general", [False, True])
def test_k1_at_head_size_256_routes_by_dtype_and_matches_plain_version(cuda, dtype, general):
    """GPT-J's head size: bf16 K1 runs `mma_kernel<256, …>`, fp32
    `tf32_kernel_wide<…>` (3xTF32; the general templates with ALiBi and
    packed segments), each named so by the profiler and within its gate of
    the plain version (bf16 2e-2 + 1e-2·|ref|, fp32 1e-5 + 1e-5·|ref|)."""
    rng = np.random.default_rng(256 + general)
    B, T, H, Dh = 3, 300, 4, 256
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda, dt) for _ in range(3))
    km, seg = (torch.from_numpy(a).to(cuda) for a in _packed_rows(rng, B, T))
    slopes = torch.from_numpy((0.03 * rng.random(H)).astype(np.float32)).to(cuda)
    kw = dict(segments=seg, positions=torch.arange(T, device=cuda).expand(B, T).contiguous()
              ) if general else {}
    names, got = _kernel_names(
        lambda: sa.short_attention(q, k, v, km, slopes, 1 / 16, 0, H, general, **kw),
        ("mma_kernel", "tf32_kernel", "scalar_kernel"))
    want = sa.short_attention_reference(q, k, v, km, slopes, scale=1 / 16, window=0, H=H,
                                        use_alibi=general, **kw)
    expect = "mma_kernel" if dtype == "bfloat16" else "tf32_kernel_wide"
    assert names and all(expect in n for n in names), names
    atol, rtol = (2e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 1e-5)
    assert ((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all()


@pytest.mark.parametrize("alibi", [False, True])
def test_k1_fp32_at_head_size_256_packed_t2048(cuda, alibi):
    """fp32 K1 at Dh 256 on packed rows of T=2,048 (up to 40 segments of
    8-90 tokens, a padded tail whose rows have no valid key), with ALiBi at
    per-segment key positions: `tf32_kernel_wide<true>` (named by the
    profiler) within the fp32 gate 1e-5 + 1e-5·|ref| of the plain version,
    fully masked rows included; an unaligned copy takes `scalar_kernel`
    within the same gate."""
    rng = np.random.default_rng(2048 + alibi)
    B, T, H, Dh = 2, 2048, 4, 256
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda) for _ in range(3))
    km_np, seg_np = _packed_rows(rng, B, T, max_segments=40)
    start = np.zeros_like(seg_np)
    for b in range(B):
        for j in range(1, T):
            start[b, j] = start[b, j - 1] if seg_np[b, j] == seg_np[b, j - 1] else j
    km, seg = (torch.from_numpy(a).to(cuda) for a in (km_np, seg_np))
    pos = torch.from_numpy((np.arange(T)[None] - start).astype(np.int32)).to(cuda)
    slopes = torch.from_numpy((0.03 * rng.random(H)).astype(np.float32)).to(cuda)
    kw = dict(segments=seg, positions=pos if alibi else None)
    names, got = _kernel_names(
        lambda: sa.short_attention(q, k, v, km, slopes, 1 / 16, 0, H, alibi, **kw),
        ("mma_kernel", "tf32_kernel", "scalar_kernel"))
    want = sa.short_attention_reference(q, k, v, km, slopes, scale=1 / 16, window=0, H=H,
                                        use_alibi=alibi, **kw)
    assert names and all("tf32_kernel_wide" in n for n in names), names
    assert (km_np == 0).any()  # a padded tail: rows with no valid key
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()
    buf = torch.empty(3, q.numel() + 1, device=cuda)
    qu, ku, vu = (buf[i, 1:].view_as(t).copy_(t) for i, t in enumerate((q, k, v)))
    names, got = _kernel_names(
        lambda: sa.short_attention(qu, ku, vu, km, slopes, 1 / 16, 0, H, alibi, **kw),
        ("mma_kernel", "tf32_kernel", "scalar_kernel"))
    assert names and all("scalar_kernel" in n for n in names), names
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k3_at_head_size_256_launches_its_templates(cuda, dtype):
    """K3 at Dh 256: `flash_fwd_bf16<256>` / `flash_fwd_tf32<256>` (named by
    the profiler), output and lse within the dtype's gate of the plain
    version, fully masked rows included; a gradient at Dh 256 runs K4a's
    `flash_bwd_dq_wide` and K4b's `flash_bwd_dkv_wide` (named by the
    profiler; no plain version on the card) within K4's gate of the plain
    version: fp32 1e-5·max|ref| + 1e-5·|ref|, bf16 `_bf16_grad_gate`."""
    from sgpt_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(3)
    B, H, T, Dh = 3, 2, 512, 256
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda, dt).view(B, T, H, Dh).transpose(1, 2) for _ in range(3))
    km = torch.from_numpy((np.arange(T)[None] < np.array([[20], [T], [T - 37]])).astype(
        np.int32)).to(cuda)
    slopes = torch.from_numpy((0.03 * rng.random(H)).astype(np.float32)).to(cuda)
    kw = dict(scale=1 / 16, window=64, block_kv=128)
    names, (got, lse) = _kernel_names(
        lambda: fa.flash_attention(q, k, v, km, slopes, return_residuals=True, **kw),
        ("flash_fwd",))
    expect = "flash_fwd_bf16" if dtype == "bfloat16" else "flash_fwd_tf32"
    assert names and all(expect in n for n in names), names
    want, want_lse = fa.flash_attention_reference(q, k, v, km, slopes, **kw)
    atol, rtol = (2e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 1e-5)
    assert ((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all()
    dead = want_lse == fa.NEG_INF
    assert torch.equal(lse == fa.NEG_INF, dead) and dead.any()
    assert ((lse - want_lse).abs()[~dead] <= 1e-4 + 1e-5 * want_lse.abs()[~dead]).all()
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    cot = torch.from_numpy(rng.normal(0, 1, (B, H, T, Dh)).astype(np.float32)).to(cuda, dt)

    def grads():
        out = fa.flash_attention(qg, kg, vg, km, slopes, **kw)
        return torch.autograd.grad(out, (qg, kg, vg), cot)

    launched = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    names, grads_got = _kernel_names(grads, ("flash_bwd",))
    assert fa.bwd_dq_launches > launched[0] and fa.bwd_dkv_launches > launched[1]
    assert any("flash_bwd_dq" in n for n in names) and any("flash_bwd_dkv" in n for n in names)
    assert all("_wide" in n for n in names), names
    grads_want = fa.flash_attention_bwd_reference(q, k, v, km, slopes, cot, got, lse, **kw)
    for gg, ww in zip(grads_got, grads_want):
        if dtype == "bfloat16":
            _bf16_grad_gate(gg, ww)
        else:
            gg, ww = gg.float(), ww.float()
            assert ((gg - ww).abs() <= 1e-5 * ww.abs().max() + 1e-5 * ww.abs()).all()


def _nli_inputs(rng, B, T, H, Dh, cuda, dtype=torch.float32):
    """q, k, v, g (std 0.5) and a key mask with ~1/3 padding in row 0 and
    batch row 1 fully padded."""
    q, k, v, g = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                  .to(cuda, dtype) for _ in range(4))
    km = np.ones((B, T), np.int32)
    km[0, 2 * T // 3:] = 0
    km[1] = 0
    return q, k, v, torch.from_numpy(km).to(cuda), g


@pytest.mark.parametrize("Dh,window", [(64, 0), (64, 256), (256, 0)])
def test_k1_k2_fp32_at_the_nli_length(cuda, Dh, window):
    """NLI training pads every tower to T=75: not a multiple of 16 and below
    one 64-key tile of K2's cols pass. fp32 K1 (`tf32_kernel`, at Dh 256
    `tf32_kernel_wide`) within 1e-5 + 1e-5·|ref| of the plain version, K2
    (`tf32_rows`/`tf32_cols`, at 256 their `_wide` pair) within its gate
    1e-5·max|ref| + 1e-5·|ref|, by kernel name; a fully padded row's dq is 0."""
    rng = np.random.default_rng(75 + Dh + window)
    B, T, H = 4, 75, 4
    q, k, v, km, g = _nli_inputs(rng, B, T, H, Dh, cuda)
    scale = Dh ** -0.5
    names, got = _kernel_names(lambda: sa.short_attention(q, k, v, km, None, scale, window, H,
                                                          False),
                               ("mma_kernel", "tf32_kernel", "scalar_kernel"))
    want = sa.short_attention_reference(q, k, v, km, None, scale=scale, window=window, H=H,
                                        use_alibi=False)
    assert names and all("tf32_kernel" in n and ("_wide" in n) == (Dh == 256)
                         for n in names), names
    assert ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()
    kw = dict(scale=scale, window=window, H=H, use_alibi=False)
    names, got = _kernel_names(lambda: sa.short_attention_bwd(q, k, v, km, None, g, **kw),
                               ("tf32_rows", "tf32_cols", "rows_kernel", "cols_kernel"))
    assert {n.split("<")[0].split("::")[-1].split("(")[0] for n in names} == (
        {"tf32_rows_wide", "tf32_cols_wide"} if Dh == 256 else {"tf32_rows", "tf32_cols"}), names
    _check_bwd_gate(got, sa.short_attention_bwd_reference(q, k, v, km, None, g, **kw))
    assert (got[0][1] == 0).all()


@pytest.mark.parametrize("T", [16, 32])
def test_k1_bf16_at_the_useb_buckets(cuda, T):
    """The USEB encode's short buckets: bf16 K1 (`mma_kernel`) within 2e-2 +
    1e-2·|ref| of the plain version, key padding and a fully padded row
    included."""
    rng = np.random.default_rng(T)
    B, H, Dh = 64, 12, 64
    q, k, v, km, _ = _nli_inputs(rng, B, T, H, Dh, cuda, torch.bfloat16)
    names, got = _kernel_names(lambda: sa.short_attention(q, k, v, km, None, 1.0, 0, H, False),
                               ("mma_kernel", "tf32_kernel", "scalar_kernel"))
    want = sa.short_attention_reference(q, k, v, km, None, scale=1.0, window=0, H=H,
                                        use_alibi=False)
    assert names and all("mma_kernel" in n for n in names), names
    assert ((got.float() - want.float()).abs() <= 2e-2 + 1e-2 * want.float().abs()).all()


@pytest.mark.parametrize("case,Q,N,D,k", [
    ("all-equal", 64, 70_000, 768, 10), ("all-equal", 3, 9000, 768, 16),
    ("split-duplicates", 64, 200_000, 768, 10), ("split-duplicates", 8, 100_000, 2048, 10),
    ("valid-tile-1", 64, 20_000, 768, 10), ("valid-tile", 64, 20_000, 768, 10),
    ("valid-tile+1", 64, 20_000, 768, 10), ("Q65", 65, 50_000, 768, 10),
    ("Q16", 16, 50_000, 768, 10), ("D2048", 40, 30_000, 2048, 10),
    ("D2560", 33, 30_000, 2560, 10), ("valid<k", 64, 5000, 768, 10)])
def test_mips_bf16_scan_hazards(cuda, case, Q, N, D, k):
    """The tensor-core scan's hazards against the plain version: every
    score equal (ids 0 .. k-1; the queue overflows on every tile of a
    split's first), exact duplicates on both sides of a pass-1 split boundary
    (the wrapper's own plan), valid_count one row either side of a 256-row
    tile boundary, two query blocks, and the widths of the larger models."""
    from sgpt_tpu_torch.ops import mips

    rng = np.random.default_rng(N + Q)
    c = _unit(rng, N, D, cuda, torch.bfloat16)
    q = _unit(rng, Q, D, cuda, torch.bfloat16)
    valid = {"valid-tile-1": 40 * 256 - 1, "valid-tile": 40 * 256,
             "valid-tile+1": 40 * 256 + 1, "valid<k": 7}.get(case, N)
    if case == "all-equal":
        c[:] = c[11].clone()
    if case == "split-duplicates":
        slots = torch.cuda.get_device_properties(cuda).multi_processor_count
        splits = mips._splits(Q, N, slots, mips.query_block(Q, D, torch.bfloat16),
                              mips.MMA_TILE_ROWS)
        b = mips._rows_per_split(N, splits, mips.MMA_TILE_ROWS)
        assert 0 < b < N - 256
        dup = [b - 1, b, b + 1, b + 256]
        c[dup] = c[17].clone()
        q[0] = c[17]
    c[valid:] = 10.0  # rows past valid_count must be invisible
    before = mips.launches
    got = mips.mips_topk(q, c, valid, k)
    torch.cuda.synchronize()
    assert mips.launches == before + 1
    _check_mips(q, c, got, mips.mips_topk_reference(q, c, valid, k))
    assert (got[1] < valid).all()
    if case == "all-equal":
        assert (got[1] == torch.arange(k, device=cuda, dtype=torch.int32)).all()
    if case == "split-duplicates":
        assert got[1][0, :5].tolist() == [17, *dup]


def test_mips_query_block_matches_the_plan(cuda):
    """`sgpt_mips_query_block` (the kernel's choice) == the wrapper's mirror
    `_mma_query_block` for bf16 at the main widths, Q 1 to 1024."""
    from sgpt_tpu_torch.ops import mips

    for D in (768, 2048, 2560):
        for Q in (1, 2, 7, 8, 9, 16, 17, 32, 33, 63, 64, 65, 100, 1024):
            assert mips.query_block(Q, D, torch.bfloat16) == mips._mma_query_block(Q, D), (Q, D)


# ---------------------------------------------------------------------------
# the cross-encoder (SGPT-CE): K1 at its packed-row shape, and its scores
# ---------------------------------------------------------------------------
def _packed_rows(rng, B, T, max_segments=16):
    """Key mask and segment ids of packed rows: segments of 8-90 tokens until
    the row or 16 segments are full; the tail is padding (segment -1, key
    mask 0), whose query rows have no valid key."""
    km = np.zeros((B, T), np.int32)
    seg = np.full((B, T), -1, np.int32)
    for b in range(B):
        off = 0
        for s in range(max_segments):
            n = int(rng.integers(8, 91))
            if off + n > T:
                break
            km[b, off:off + n], seg[b, off:off + n] = 1, s
            off += n
    return km, seg


@pytest.mark.parametrize("window", [0, 256])
def test_kernel_at_the_packed_ce_shape_matches_plain_version(cuda, window):
    """bf16 K1 with segments (`mma_kernel<64, GENERAL>`) at the packed CE
    rows' shape: T=256, H=12, Dh=64, up to 16 segments and padding a row."""
    rng = np.random.default_rng(window + 1)
    B, T, H, Dh = 16, 256, 12, 64
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
               .to(cuda, torch.bfloat16) for _ in range(3))
    km, seg = (torch.from_numpy(a).to(cuda) for a in _packed_rows(rng, B, T))
    before = sa.launches
    got = sa.short_attention(q, k, v, km, None, 1.0, window, H, False, segments=seg)
    torch.cuda.synchronize()
    assert sa.launches == before + 1
    want = sa.short_attention_reference(q, k, v, km, None, scale=1.0, window=window, H=H,
                                        use_alibi=False, segments=seg)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


def test_ce_scores_on_the_card_equal_the_cpu(cuda):
    """fp32 cross-encoder scores on the card (K1) == on the CPU (K1's plain
    version), bucketed and packed, prompt G and Yes/No: rtol 2e-5, atol 1e-4
    on summed log-probs."""
    import copy

    from sgpt_tpu_torch import crossencoder as ce
    from sgpt_tpu_torch.models import Decoder, tiny
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    cfg = tiny("neo", num_layers=2, hidden_size=128, num_heads=2, vocab_size=512,
               max_position_embeddings=512)  # Dh=64: K1's tensor-core path
    tok = SimpleTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(0)
    pairs = [(" ".join(f"q{i}w{j}" for j in range(int(rng.integers(1, 9)))),
              " ".join(f"d{int(w)}" for w in rng.integers(0, 300, int(n))))
             for i, n in enumerate(rng.integers(2, 300, 40))]
    on_cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    on_card = copy.deepcopy(on_cpu).to(cuda)
    for cls, kw in (("CrossEncoderRanker", {}), ("CrossEncoderRanker", {"pack_t": 128}),
                    ("YesNoRanker", {"pack_t": 128})):
        kw.update(batch_size=4, max_length=512)
        want = getattr(ce, cls)(on_cpu, cfg, tok, device="cpu", **kw).predict(pairs)
        before = sa.launches
        got = getattr(ce, cls)(on_card, cfg, tok, device=cuda, **kw).predict(pairs)
        assert sa.launches > before
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4, err_msg=f"{cls} {kw}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernels_with_bloom_slopes_match_plain_version(cuda, dtype):
    """K1 (unpacked, and packed with positions restarting per segment) and
    K3 with BLOOM's real slopes (`alibi_slopes(16)`, Dh 128, scale
    1/sqrt(128)) at T=1024: bf16 within 2e-2 + 1e-2·|ref|; fp32 within
    1e-5 + 1e-5·|ref|, or, where scores of ~10^2-10^3 make one fp32 rounding
    of a score move the output past that (in the plain version too), no
    further from an fp64 evaluation than twice the plain version is."""
    from sgpt_tpu_torch.models.decoder import alibi_slopes
    from sgpt_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(16)
    B, T, H, Dh = 2, 1024, 16, 128
    dt = getattr(torch, dtype)
    q2, k2, v2 = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                  .to(cuda, dt) for _ in range(3))
    km, seg = (torch.from_numpy(a).to(cuda) for a in _packed_rows(rng, B, T))
    slopes = alibi_slopes(H, cuda)
    scale = Dh ** -0.5
    atol, rtol = (2e-2, 1e-2) if dtype == "bfloat16" else (1e-5, 1e-5)
    full = torch.ones_like(km)

    def held(got, want, exact):
        ok = (got.float() - want.float()).abs() <= atol + rtol * want.float().abs()
        if ok.all():
            return
        assert dtype == "float32", "bf16 outside its gate"
        e = exact()
        assert (got.double() - e).abs().max() <= 2 * (want.double() - e).abs().max()

    def k1_exact(mask, kp):
        q, k, v = (t.reshape(B, T, H, Dh).double() for t in (q2, k2, v2))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        s = s + slopes.double()[None, :, None, None] * kp.double()[:, None, None, :]
        s = torch.where(mask, s, torch.full((), -1e9, dtype=s.dtype, device=cuda))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(B, T, H * Dh)

    i = torch.arange(T, device=cuda)
    causal = (i[None, :] <= i[:, None])[None, None]
    # unpacked rows: the key index as the ALiBi position
    got = sa.short_attention(q2, k2, v2, full, slopes, scale, 0, H, True)
    want = sa.short_attention_reference(q2, k2, v2, full, slopes, scale=scale, window=0, H=H,
                                        use_alibi=True)
    held(got, want, lambda: k1_exact(causal.expand(B, 1, T, T), i.expand(B, T)))
    # packed rows: positions restart in each segment (and in the padding tail)
    starts = [np.flatnonzero(np.diff(np.concatenate([[-2], s])) != 0) for s in seg.cpu().numpy()]
    pos = torch.from_numpy(np.stack([np.arange(T) - st[np.searchsorted(st, np.arange(T),
                                                                         side="right") - 1]
                                     for st in starts]).astype(np.int32)).to(cuda)
    kw = dict(segments=seg, positions=pos)
    got = sa.short_attention(q2, k2, v2, km, slopes, scale, 0, H, True, **kw)
    want = sa.short_attention_reference(q2, k2, v2, km, slopes, scale=scale, window=0, H=H,
                                        use_alibi=True, **kw)
    mask = causal & (km > 0)[:, None, None, :] & (seg[:, :, None] == seg[:, None, :])[:, None]
    held(got, want, lambda: k1_exact(mask, pos))
    # K3: the key index as the ALiBi position, right padding
    qh, kh, vh = (t.view(B, T, H, Dh).transpose(1, 2) for t in (q2, k2, v2))
    kmr = torch.from_numpy((np.arange(T)[None] < np.array([[T], [T - 300]])).astype(
        np.int32)).to(cuda)
    got = fa.flash_attention(qh, kh, vh, kmr, slopes, scale=scale, block_kv=256)
    want, _ = fa.flash_attention_reference(qh, kh, vh, kmr, slopes, scale=scale, block_kv=256)

    def k3_exact():
        m = causal & (kmr > 0)[:, None, None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qh.double(), kh.double()) * scale
        s = s + slopes.double()[None, :, None, None] * i.double()
        p = torch.softmax(s.masked_fill(~m, float("-inf")), -1)
        return torch.einsum("bhqk,bhkd->bhqd", p, vh.double())

    held(got, want, k3_exact)


def test_families_on_the_card_equal_the_cpu(cuda):
    """Tiny GPT-J (head size 256: K1's `mma_kernel<256>` in bf16 and
    `scalar_kernel` in fp32; K3 with use_flash) and BLOOM (ALiBi), fp32:
    engine embeddings on the card == on the CPU within 1e-4, CE scores
    (GPT-J with a biased head, BLOOM packed) within rtol 2e-5, atol 1e-4."""
    import copy

    from sgpt_tpu_torch import crossencoder as ce
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, tiny
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    rng = np.random.default_rng(1)
    texts = [" ".join(f"w{int(w)}" for w in rng.integers(0, 400, int(n)))
             for n in rng.integers(2, 400, 12)]
    pairs = [(" ".join(f"q{i}w{j}" for j in range(int(rng.integers(1, 9)))), t)
             for i, t in enumerate(texts)]
    for family, head in (("gptj", ("w", "b")), ("bloom", ())):
        cfg = tiny(family, num_layers=2, hidden_size=512, num_heads=2, vocab_size=512,
                   max_position_embeddings=512, use_flash=True)
        tok = SimpleTokenizer(cfg.vocab_size)
        on_cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                         lm_head=head)
        on_card = copy.deepcopy(on_cpu).to(cuda)
        kw = dict(specb=True, max_seq_len=512, batch_size=4, normalize_embeddings=True)
        want = EmbeddingEngine(on_cpu, cfg, tok, device="cpu", **kw).encode(texts)
        before = fa.launches
        got = EmbeddingEngine(on_card, cfg, tok, device=cuda, **kw).encode(texts)
        assert fa.launches > before
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=family)
        ckw = dict(batch_size=4, max_length=512, pack_t=None if family == "gptj" else 128)
        want = ce.CrossEncoderRanker(on_cpu, cfg, tok, device="cpu", **ckw).predict(pairs)
        got = ce.CrossEncoderRanker(on_card, cfg, tok, device=cuda, **ckw).predict(pairs)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4, err_msg=family)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["gptj", "bloom"])
def test_backward_kernel_at_the_families_training_shapes(cuda, dtype, family):
    """K2 at GPT-J's head size 256 (fp32 on the 3xTF32 `tf32_rows_wide` /
    `tf32_cols_wide`, bf16 on the CUDA-core `rows_kernel` / `cols_kernel`;
    the routing by name is `test_fp32_backward_routing_and_gate`'s, which
    runs before the K5 hazards) and with BLOOM-1b7's real slopes (`alibi_slopes(16)`, Dh
    128, the key index as position), T=300, key padding and a fully padded
    row: within K2's gate of the plain version (bf16 `_bf16_grad_gate`,
    fp32 1e-5·max|ref| + 1e-5·|ref|), or for fp32 under BLOOM's slopes, where
    scores of ~10^2 can put one fp32 rounding past it in the plain version
    too, no further from an fp64 evaluation than twice the plain version."""
    from sgpt_tpu_torch.models.decoder import alibi_slopes

    rng = np.random.default_rng(300)
    B, T = 3, 300
    H, Dh = (4, 256) if family == "gptj" else (16, 128)
    dt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                  .to(cuda, dt) for _ in range(4))
    km = np.ones((B, T), np.int32)
    km[0, 200:] = 0
    km[1] = 0
    km = torch.from_numpy(km).to(cuda)
    alibi = family == "bloom"
    slopes = alibi_slopes(H, cuda) if alibi else None
    kw = dict(scale=Dh ** -0.5, window=0, H=H, use_alibi=alibi)
    before = sa.bwd_launches
    got = sa.short_attention_bwd(q, k, v, km, slopes, g, **kw)
    torch.cuda.synchronize()
    assert sa.bwd_launches == before + 1
    want = sa.short_attention_bwd_reference(q, k, v, km, slopes, g, **kw)
    exact = None
    for i, (gg, ww) in enumerate(zip(got, want)):
        assert gg.dtype == dt
        if dtype == "bfloat16":
            _bf16_grad_gate(gg, ww)
            continue
        if ((gg - ww).abs() <= 1e-5 * ww.abs().max() + 1e-5 * ww.abs()).all():
            continue
        assert alibi, "outside K2's gate"
        if exact is None:
            qd, kd, vd = (t.reshape(B, T, H, Dh).double().requires_grad_() for t in (q, k, v))
            s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * Dh ** -0.5
            s = s + slopes.double()[None, :, None, None] * torch.arange(
                T, device=cuda, dtype=torch.float64)
            i_ = torch.arange(T, device=cuda)
            mask = (i_[None, :] <= i_[:, None])[None, None] & (km > 0)[:, None, None, :]
            s = torch.where(mask, s, torch.full((), -1e9, dtype=s.dtype, device=cuda))
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
            exact = [x.reshape(B, T, H * Dh) for x in torch.autograd.grad(
                o, (qd, kd, vd), g.reshape(B, T, H, Dh).double())]
        assert (got[i].double() - exact[i]).abs().max() <= \
            2 * (want[i].double() - exact[i]).abs().max()
    assert (got[0][1] == 0).all()  # dq of a fully padded row


@pytest.mark.parametrize("method,layeridx", [("meanmean", -1), ("lasttokenmean", -1),
                                             ("weightedmean", 1)])
def test_stack_pooled_encode_on_the_card_equals_the_cpu(cuda, method, layeridx):
    """A 2-layer model at GPT-Neo-125M's width, fp32: an encode over the
    stack of all layers' states (or one middle layer's) on the card (K1 in
    every layer of every batch) equals the CPU's (plain versions) within
    1e-4, as the flash engine test holds it."""
    import copy

    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    cfg = gpt_neo("125m").replace(num_layers=2)
    cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(1)
    texts = [" ".join(f"w{rng.integers(0, 9000)}" for _ in range(n)) for n in (3, 12, 30, 70)]
    kw = dict(method=method, layeridx=layeridx, max_seq_len=128, batch_size=2,
              normalize_embeddings=True)
    tok = SimpleTokenizer(cfg.vocab_size)
    want = EmbeddingEngine(cpu, cfg, tok, device="cpu", **kw).encode(texts)
    before = sa.launches
    got = EmbeddingEngine(gpu, cfg, tok, device=cuda, **kw).encode(texts)
    assert sa.launches > before
    np.testing.assert_allclose(got, want, atol=1e-4)
