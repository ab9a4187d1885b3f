"""Port's fused short-T attention (plain version on the CPU) == the JAX kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_short_attention.py does, and its `_reference_hd` oracle. Inputs
come from a numpy seed. fp32 throughout; tolerance 1e-5 absolute.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops.pallas.short_attention import _reference_hd  # noqa: E402
from sgpt_tpu.ops.pallas.short_attention import short_attention as jax_short_attention  # noqa: E402
from sgpt_tpu_torch.ops import short_attention as sa  # noqa: E402

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The emulations below run thousands of small tensor operations. With
    a pool of intra-op threads in each of several test processes sharing
    the host's cores, every operation's thread barrier waits on threads
    that are not running, and a run of seconds takes many minutes. One
    thread gives the same values: no emulation's product or sum depends on
    the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, H, Dh, pad_at=None, segments=False, alibi=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H * Dh)).astype(np.float32) for _ in range(3))
    km = np.ones((B, T), np.int32)
    if pad_at is not None:
        km[-1, pad_at:] = 0
    slopes = (rng.random(H) if alibi else np.zeros(H)).astype(np.float32)
    seg = pos = None
    if segments or alibi:  # three contiguous segments, positions restart in each
        cuts = np.sort(rng.choice(np.arange(4, T - 4), size=2, replace=False))
        seg_row = np.searchsorted(cuts, np.arange(T), side="right").astype(np.int32)
        pos_row = np.arange(T) - np.concatenate([[0], cuts])[seg_row]
        seg = np.tile(seg_row, (B, 1)) if segments else None
        pos = np.tile(pos_row, (B, 1)).astype(np.int32) if alibi else None
    return q, k, v, km, slopes, seg, pos


CASES = {  # name: (T, scale, window, pad_at, alibi, segments)
    "plain": (40, 1.0, 0, None, False, False),
    "scale": (40, 0.25, 0, 30, False, False),
    "window": (40, 1.0, 8, 30, False, False),
    "window-scale": (40, 0.25, 8, 30, False, False),
    # rows 46.. of the last batch row see no valid key: uniform 1/T softmax
    "fully-masked-rows": (60, 1.0, 16, 30, False, False),
    "alibi-positions": (48, 1.0, 0, 40, True, False),
    "segments": (48, 0.25, 0, 42, False, True),
    "segments-alibi-window": (48, 1.0, 8, 42, True, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel_and_reference(name):
    T, scale, window, pad_at, alibi, segments = CASES[name]
    B, H, Dh = 2, 4, 16
    q, k, v, km, slopes, seg, pos = _inputs(len(name), B, T, H, Dh, pad_at,
                                            segments, alibi)
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    got = sa.short_attention(tt(q), tt(k), tt(v), tt(km), tt(slopes), scale,
                             window, H, alibi, segments=tt(seg), positions=tt(pos))
    jj = (lambda a: None if a is None else jnp.asarray(a))
    want_kernel = jax_short_attention(jj(q), jj(k), jj(v), jj(km), jj(slopes),
                                      scale, window, H, alibi,
                                      segments=jj(seg), positions=jj(pos))
    want_ref = _reference_hd(jj(q), jj(k), jj(v), jj(km), jj(slopes), scale=scale,
                             window=window, H=H, use_alibi=alibi,
                             segments=jj(seg), positions=jj(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL)


def test_fully_masked_rows_are_uniform():
    """A padded query row that the window leaves with no valid key averages
    V over all T keys (softmax of T equal -1e9 scores), as the TPU kernel does."""
    T, H, Dh, window = 60, 2, 16, 16
    q, k, v, km, slopes, _, _ = _inputs(0, 2, T, H, Dh, pad_at=30)
    got = sa.short_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(km), None, scale=1.0, window=window, H=H, use_alibi=False)
    np.testing.assert_allclose(got[1, 46:].numpy(),
                               np.broadcast_to(v[1].mean(0), (T - 46, H * Dh)),
                               atol=ATOL)


TILE = 64  # K1's query rows per block and keys per tile on the card


def _visit_rule(q2, k2, v2, key_mask, slopes, *, scale, window, H, use_alibi,
                segments=None, positions=None):
    """K1's walk on the card, in plain PyTorch: per 64-row query tile, pass 1
    takes the row max m and sum l over the key tiles that hold a causal,
    in-window pair for the tile, plus exp(-1e9 − m) for each pruned key;
    a tile with a row whose visited keys are all masked (m == -1e9) walks
    every key in pass 2, the others only the visited tiles; p = exp(s − m)
    / l, cast to the input dtype, then P·V. Returns the output and the
    numbers of pruned keys and of tiles that walked every key."""
    B, T, HD = q2.shape
    s, _ = sa._scores(q2, k2, key_mask, slopes, scale=scale, window=window, H=H,
                      use_alibi=use_alibi, segments=segments, positions=positions)
    v = v2.reshape(B, T, H, HD // H).permute(0, 2, 1, 3).float()
    out = torch.zeros(B, H, T, HD // H)
    pruned = walked_all = 0
    for q0 in range(0, T, TILE):
        rows = slice(q0, min(q0 + TILE, T))
        lo = max(0, q0 - window + 1) // TILE * TILE if window > 0 else 0
        hi = min(T, (min(q0 + TILE - 1, T - 1) // TILE + 1) * TILE)
        st = s[:, :, rows]
        m = torch.clamp(st[..., lo:hi].amax(-1, keepdim=True), min=sa.NEG)
        n_pruned = T - (hi - lo)
        l = torch.exp(st[..., lo:hi] - m).sum(-1, keepdim=True) + n_pruned * torch.exp(sa.NEG - m)
        dead = (m == sa.NEG).flatten(2).any(-1)[..., None, None]  # per (batch row, head)
        keys = torch.zeros(T, dtype=torch.bool)
        keys[lo:hi] = True
        visit = dead | keys
        p = torch.where(visit, torch.exp(st - m) / l, torch.zeros(()))
        out[:, :, rows] = torch.einsum("bhqk,bhkd->bhqd", p.to(q2.dtype).float(), v)
        pruned += n_pruned
        walked_all += int(dead.sum())
    return out.permute(0, 2, 1, 3).reshape(B, T, HD).to(q2.dtype), pruned, walked_all


VISIT_CASES = {  # name: (T, scale, window, pad_at, alibi, segments)
    "causal-T130": (130, 1.0, 0, 100, False, False),
    "causal-T200-scale": (200, 0.25, 0, None, False, False),
    "window16-T200-padded": (200, 1.0, 16, 100, False, False),      # rows 116.. fully masked
    "window256-T300-padded": (300, 1.0, 256, 30, False, False),     # rows 286.. fully masked
    "segments-T150": (150, 0.25, 0, 140, False, True),
    "alibi-positions-window16-T190": (190, 1.0, 16, 170, True, False),
    "segments-alibi-window16-T260": (260, 1.0, 16, 200, True, True),
}


@pytest.mark.parametrize("name", sorted(VISIT_CASES))
def test_k1_visit_rule_changes_no_value(name):
    """The CPU witness that K1's pruning on the card changes no output:
    restricting each 64-row tile to the key tiles it visits, counting the
    pruned keys analytically and walking every key for a tile with a fully
    masked row gives `short_attention_reference` in every row, fully masked
    ones included."""
    T, scale, window, pad_at, alibi, segments = VISIT_CASES[name]
    B, H, Dh = 2, 2, 16
    q, k, v, km, slopes, seg, pos = _inputs(T + window, B, T, H, Dh, pad_at, segments, alibi)
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, segments=tt(seg),
              positions=tt(pos))
    args = (tt(q), tt(k), tt(v), tt(km), tt(slopes))
    want = sa.short_attention_reference(*args, **kw)
    got, pruned, walked_all = _visit_rule(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    assert pruned > 0  # the rule does prune: T spans more than one tile
    if "padded" in name:  # the window leaves the padded tail with no valid key
        assert walked_all > 0
        dead = pad_at + window
        np.testing.assert_allclose(got[-1, dead:].numpy(),
                                   np.broadcast_to(v[-1].mean(0), (T - dead, H * Dh)),
                                   atol=ATOL)


def test_cpu_tensor_takes_plain_version_without_counting():
    q, k, v, km, _, _, _ = _inputs(1, 2, 24, 2, 8)
    before = sa.launches
    args = [torch.from_numpy(a) for a in (q, k, v, km)]
    got = sa.short_attention(*args, None, 1.0, 0, 2, False)
    want = sa.short_attention_reference(*args, None, scale=1.0, window=0, H=2,
                                        use_alibi=False)
    assert torch.equal(got, want)
    assert sa.launches == before


def test_bf16_plain_version_casts_probabilities():
    """bf16 in → bf16 out, probabilities rounded to bf16 before P·V, as in
    the JAX reference (compared on the same bf16-rounded inputs)."""
    q, k, v, km, slopes, _, _ = _inputs(2, 2, 40, 4, 16, pad_at=30)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = sa.short_attention(*tb, torch.from_numpy(km), None, 1.0, 8, 4, False)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    want = _reference_hd(*jb, jnp.asarray(km), jnp.asarray(slopes), scale=1.0,
                         window=8, H=4, use_alibi=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2)


def _tf32(x):
    """`cvt.rna.tf32.f32` in plain PyTorch: round an fp32 tensor to nearest
    at 10 stored mantissa bits, ties away from zero (a half unit of the kept
    bits added to the magnitude, the 13 dropped bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _mma_tf32(a, b, order, three, swapped=False, halves=False):
    """a (..., M, K) · b (..., K, N) as K1's fp32 kernel takes it on the
    card: m16n8k8 steps of 8 along K; per step the TF32 products a_s·b_b,
    a_b·b_s, a_b·b_b (3xTF32, the small terms first; `swapped`, K2's cols
    pass: a_b·b_s, a_s·b_b, a_b·b_b; `three=False`: a_b·b_b alone), each
    product exact and added in turn, the step's 8 terms in `order`, to a
    zeroed fp32 accumulator whose sum is then added to the running one.
    `halves` (the scores at Dh 256, whose two halves two warps sum): the
    steps of each half of K run from zero, then the halves are added.

    Every k-step's accumulator is formed at once (a leading axis of K / 8
    steps), each of its terms added in the same sequence as one step alone
    would add them, then the steps are added to the running sum in K's
    order: the same products and the same additions as a loop over the
    steps, in a few dozen tensor operations instead of 24 per step."""
    (ab, asm), (bb, bsm) = _split(a), _split(b)
    if not three:
        terms = ((ab, bb),)
    elif swapped:
        terms = ((ab, bsm), (asm, bb), (ab, bb))
    else:
        terms = ((asm, bb), (ab, bsm), (ab, bb))
    K, N = a.shape[-1], b.shape[-1]
    n = K // 8
    steps = (lambda x: x.unflatten(-1, (n, 8)).movedim(-2, 0),       # (n, ..., M, 8)
             lambda y: y.unflatten(-2, (n, 8)).movedim(-3, 0))       # (n, ..., 8, N)
    step = torch.zeros(n, *a.shape[:-1], N)
    for x, y in terms:
        xs, ys = steps[0](x), steps[1](y)
        for kk in order:
            step = step + xs[..., :, kk, None] * ys[..., None, kk, :]
    acc = [torch.zeros(*a.shape[:-1], N) for _ in range(2)]
    for s in range(n):
        h = int(halves and 8 * s >= K // 2)
        acc[h] = acc[h] + step[s]
    return acc[0] + acc[1] if halves else acc[0]


# A column κ of a P·V step is key 2κ (κ < 4) or 2(κ − 4) + 1 of its 8-key
# group: the S accumulator's columns taken as P's A fragment unshuffled.
PV_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _k1_tf32(q2, k2, v2, key_mask, slopes, *, scale, window, H, use_alibi, segments=None,
             positions=None, three=True):
    """K1's fp32 formula with its products in (3x)TF32: S = Q·Kᵀ (at Dh 256,
    `tf32_kernel_wide`, in two halves of Dh), scale, ALiBi and where(mask, s,
    -1e9) as `_scores`, the fp32 softmax, P unrounded, then P·V with each
    8-key step in PV_ORDER (keys past T padded to a multiple of 8 with p =
    0)."""
    B, T, HD = q2.shape
    Dh = HD // H
    q, k, v = (t.reshape(B, T, H, Dh).transpose(1, 2).float() for t in (q2, k2, v2))
    s = _mma_tf32(q, k.transpose(-1, -2), range(8), three, halves=Dh == 256)
    _, mask = sa._scores(q2, k2, key_mask, slopes, scale=scale, window=window, H=H,
                         use_alibi=use_alibi, segments=segments, positions=positions)
    if scale != 1.0:
        s = s * scale
    if use_alibi:
        kp = positions if positions is not None else torch.arange(T).expand(B, T)
        s = s + slopes.float()[None, :, None, None] * kp.float()[:, None, None, :]
    p = torch.softmax(torch.where(mask, s, torch.full((), sa.NEG)), dim=-1)
    pad = -T % 8
    p = torch.nn.functional.pad(p, (0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    o = _mma_tf32(p, v, PV_ORDER, three)
    return o.transpose(1, 2).reshape(B, T, HD)


TF32_CASES = {  # name: (T, Dh, scale, window, pad_at, alibi, segments)
    "causal-T300-Dh64": (300, 64, 1.0, 0, 200, False, False),
    "window256-T300-Dh64": (300, 64, 1.0, 256, 20, False, False),  # rows 276.. fully masked
    "window16-T77-Dh16-fully-masked": (77, 16, 1.0, 16, 30, False, False),  # rows 46..
    "scale-T300-Dh32": (300, 32, 0.125, 0, None, False, False),
    "alibi-window16-T77-Dh128": (77, 128, 1.0, 16, 60, True, False),
    "segments-scale-T300-Dh128": (300, 128, 0.125, 0, 250, False, True),
    "segments-alibi-T77-Dh32": (77, 32, 1.0, 0, None, True, True),
    # GPT-J's head size (`tf32_kernel_wide` on the card): its scale with key
    # padding, fully masked rows (76..) and packed segments with ALiBi
    "scale16-padded-T150-Dh256": (150, 256, 0.0625, 0, 100, False, False),
    "window16-T120-Dh256-fully-masked": (120, 256, 0.0625, 16, 60, False, False),
    "segments-alibi-T130-Dh256": (130, 256, 0.0625, 0, 110, True, True),
}


def _tf32_case(name):
    T, Dh, scale, window, pad_at, alibi, segments = TF32_CASES[name]
    B, H = 2, 2
    q, k, v, km, slopes, seg, pos = _inputs(T + Dh, B, T, H, Dh, pad_at, segments, alibi)
    q, k, v = (x * np.float32(0.5) for x in (q, k, v))  # std 0.5, as the card's checks use
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, segments=tt(seg),
              positions=tt(pos))
    return (tt(q), tt(k), tt(v), tt(km), tt(slopes)), kw, (q, k, v, km, slopes, seg, pos)


def _gate(got, want):
    """K1's fp32 gate: |Δ| ≤ 1e-5 + 1e-5·|ref| in every element; returns the
    largest excess over the 1e-5 of the absolute part."""
    return float(((got - want).abs() - 1e-5 * want.abs()).max())


@pytest.mark.parametrize("name", sorted(TF32_CASES))
def test_3xtf32_products_hold_the_fp32_gate(name):
    """The CPU witness of K1's fp32 numerics on the card: 3xTF32 products
    (cvt.rna splits, the permuted P·V key order, fp32 accumulation) stay
    within the fp32 gate of the exact plain version and of the JAX oracle,
    fully masked rows included."""
    args, kw, (q, k, v, km, slopes, seg, pos) = _tf32_case(name)
    got = _k1_tf32(*args, **kw)
    want = sa.short_attention_reference(*args, **kw)
    jj = (lambda a: None if a is None else jnp.asarray(a))
    oracle = torch.from_numpy(np.array(_reference_hd(
        jj(q), jj(k), jj(v), jj(km), jj(slopes), scale=kw["scale"], window=kw["window"],
        H=kw["H"], use_alibi=kw["use_alibi"], segments=jj(seg), positions=jj(pos))))
    assert _gate(got, want) <= 1e-5
    assert _gate(got, oracle) <= 1e-5


@pytest.mark.parametrize("name", ["causal-T300-Dh64", "scale16-padded-T150-Dh256"])
def test_single_tf32_product_fails_the_fp32_gate(name):
    """Why K1 splits its operands: one TF32 product per pair (11 significand
    bits) misses the fp32 gate at the train shape's T=300, and at GPT-J's
    head size and scale."""
    args, kw, _ = _tf32_case(name)
    want = sa.short_attention_reference(*args, **kw)
    assert _gate(_k1_tf32(*args, **kw, three=False), want) > 1e-5
    assert _gate(_k1_tf32(*args, **kw), want) <= 1e-5


@pytest.mark.parametrize("name", sorted(n for n in TF32_CASES if "Dh256" in n))
def test_3xtf32_at_head_size_256_holds_the_fp32_gate_against_the_jax_kernel(name):
    """The witness of `tf32_kernel_wide` (GPT-J's fp32 K1: two warps to each
    16 rows, each summing half of Dh into S, S = S_lo + S_hi, and keeping
    half of O's columns) against the JAX kernel in interpret mode, within
    the fp32 gate."""
    args, kw, (q, k, v, km, slopes, seg, pos) = _tf32_case(name)
    jj = (lambda a: None if a is None else jnp.asarray(a))
    kernel = torch.from_numpy(np.array(jax_short_attention(
        jj(q), jj(k), jj(v), jj(km), jj(slopes), kw["scale"], kw["window"], kw["H"],
        kw["use_alibi"], segments=jj(seg), positions=jj(pos))))
    assert _gate(_k1_tf32(*args, **kw), kernel) <= 1e-5


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 neighbour of 1
    x = torch.tensor([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -20, 1 + 3 * 2.0 ** -11,
                      -(1 + 2.0 ** -11), 3.0e-3, -7.5], dtype=torch.float32)
    want = [1.0, one, 1.0, 1 + 2 * 2.0 ** -10, -one]
    assert _tf32(x)[:5].tolist() == want
    big, small = _split(x)
    assert torch.equal(big + small, x)  # these need no more than 22 bits
    assert (_tf32(big) == big).all() and (_tf32(small) == small).all()
