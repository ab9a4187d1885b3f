#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`sgpt_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which asserts; any failure exits non-zero:
  1. build   — compile the CUDA kernels from `sgpt_tpu_torch/csrc/` with nvcc (sm_90a)
  2. kernel  — the fused short-T attention kernel against its plain PyTorch
               version on the card, at the encode path's shape and variants
  3. slice   — bulk encode with full-width GPT-Neo-125M (random weights from a
               seed, bf16) through `EmbeddingEngine`, documents and queries;
               the kernel's launch count must be 12 × the number of batches
  4. parity  — the same weights in fp32 on the card (kernel) against fp32 on
               the CPU (plain path), and bf16-card against fp32-CPU cosines
  5. report  — kernel and plain-version times, encode rate, the card's name
               and power limit, one `{"kernels": [...]}` line, and last
               `{"ok": true, "device": {...}}`

Without a CUDA card it exits non-zero and prints no result. Imports no JAX.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2   # bf16 outputs: a flipped rounding of P or O
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5   # fp32, TF32 off: summation order only


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(torch, rng, B, T, H, Dh, dtype, *, alibi=False, segments=False):
    """q/k/v at the scale of real projections (std 0.5), ~10 % right padding
    including a row short enough that a window leaves its tail fully masked.
    Returns (q2, k2, v2, key_mask, slopes) and the segments/positions keywords."""
    def t(shape):
        return torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32)).to("cuda", dtype)

    q, k, v = (t((B, T, H * Dh)) for _ in range(3))
    lengths = np.full(B, T)
    n_pad = max(1, B // 5)
    lengths[:n_pad] = rng.integers(max(1, T // 2), T, n_pad)
    lengths[0] = max(1, min(30, T // 4))
    km = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)).cuda()
    extra = {}
    if segments or alibi:  # three contiguous segments; positions restart in each
        cuts = np.sort(rng.choice(np.arange(1, T), size=2, replace=False))
        seg = np.searchsorted(cuts, np.arange(T), side="right").astype(np.int32)
        pos = (np.arange(T) - np.concatenate([[0], cuts])[seg]).astype(np.int32)
        if segments:
            extra["segments"] = torch.from_numpy(np.tile(seg, (B, 1))).cuda()
        if alibi:
            extra["positions"] = torch.from_numpy(np.tile(pos, (B, 1))).cuda()
    slopes = torch.from_numpy(rng.random(H).astype(np.float32)).cuda() if alibi else None
    return (q, k, v, km, slopes), extra


def phase_kernel(torch, sa, rng):
    """K1 against its plain version; returns the main-path error and times."""
    cases = [  # name, B, T, H, Dh, scale, window, alibi, segments
        ("main-global", 64, 300, 12, 64, 1.0, 0, False, False),
        ("main-local256", 64, 300, 12, 64, 1.0, 256, False, False),
        ("scale", 8, 300, 12, 64, 0.125, 0, False, False),
        ("alibi-kpos", 8, 300, 12, 64, 1.0, 256, True, False),
        ("segments", 8, 300, 12, 64, 0.125, 0, False, True),
        ("odd-T77", 5, 77, 12, 64, 1.0, 16, False, False),
        ("T2048", 2, 2048, 12, 64, 1.0, 256, False, False),
        ("Dh128-T2048", 1, 2048, 16, 128, 1.0, 256, True, True),  # GPT-Neo 1.3B/2.7B heads
        ("Dh32", 4, 100, 4, 32, 0.25, 0, False, False),
        ("Dh16", 4, 100, 4, 16, 1.0, 8, True, False),
        ("Dh48-scalar", 4, 130, 4, 48, 1.0, 0, False, True),  # bf16 off the tensor cores
    ]
    main_err = 0.0
    for dtype, atol, rtol in ((torch.bfloat16, BF16_ATOL, BF16_RTOL),
                              (torch.float32, FP32_ATOL, FP32_RTOL)):
        for name, B, T, H, Dh, scale, window, alibi, segments in cases:
            args, extra = attention_inputs(torch, rng, B, T, H, Dh, dtype,
                                           alibi=alibi, segments=segments)
            got = sa.short_attention(*args, scale, window, H, alibi, **extra)
            want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                                use_alibi=alibi, **extra)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, name
            g, w = got.float(), want.float()
            assert torch.isfinite(g).all(), f"{name}: non-finite kernel output"
            err = (g - w).abs()
            worst = (err - rtol * w.abs()).max().item()
            log(f"kernel {name:14s} {str(dtype)[6:]:8s} B={B} T={T} H={H} Dh={Dh} "
                f"max_abs_err={err.max().item():.3e} (atol {atol}, rtol {rtol})")
            assert worst <= atol, f"kernel {name} {dtype}: exceeds tolerance"
            if name.startswith("main") and dtype == torch.bfloat16:
                main_err = max(main_err, err.max().item())

    times = {}
    for window in (0, 256):
        args, _ = attention_inputs(torch, rng, 64, 300, 12, 64, torch.bfloat16)

        def kernel():
            return sa.short_attention(*args, 1.0, window, 12, False)

        def plain():
            return sa.short_attention_reference(*args, scale=1.0, window=window, H=12,
                                                use_alibi=False)

        p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kernel, kernel, plain))
        times[window] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"time K1 B=64 T=300 H=12 Dh=64 bf16 window={window}: kernel "
            f"{times[window][0]:.4f} ms, plain {times[window][1]:.4f} ms "
            f"(runs: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f})")
    return main_err, times


def cosine(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def synthetic_texts(rng) -> list:
    """1,280 texts whose SPECB lengths give every length bucket from 16 to 300
    a batch of its own, and truncate 70 past 300 tokens. Rows per batch grow
    as the bucket shrinks (64 at T=300, 512 at T=32), so each shorter bucket
    holds more texts than the longer batch before it can swallow."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    spans = [(1, 15, 530), (15, 31, 280), (31, 63, 150), (63, 127, 100),
             (127, 255, 100), (255, 299, 50), (299, 450, 70)]  # words: lo, hi, count
    lengths = np.concatenate([rng.integers(lo, hi, n) for lo, hi, n in spans])
    rng.shuffle(lengths)
    return [" ".join(rng.choice(words, int(m))) for m in lengths]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke runs "
              "only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sgpt_tpu.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.ops import _build
    from sgpt_tpu_torch.ops import short_attention as sa

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; card: {card}")

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {lib_path.relative_to(_build.PKG.parent)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    # 2. kernel against its plain version
    rng = np.random.default_rng(SEED)
    main_err, times = phase_kernel(torch, sa, rng)

    # 3. the slice: full-width GPT-Neo-125M bulk encode through the engine
    cfg = gpt_neo("125m", dtype=torch.bfloat16)
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    tok = SimpleTokenizer(cfg.vocab_size)
    engine = EmbeddingEngine(model, cfg, tok, device="cuda", specb=True, max_seq_len=300,
                             batch_size=64, normalize_embeddings=True)
    texts = synthetic_texts(rng)
    _, n_trunc, _ = engine.codec.encode_rows(texts)
    assert n_trunc > 0, "no text reached truncation"
    engine.warmup()
    torch.cuda.synchronize()

    shapes = []
    hook = model.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    sa.launches = 0
    t0 = time.perf_counter()
    docs = engine.encode(texts)
    torch.cuda.synchronize()
    doc_s = time.perf_counter() - t0
    n_doc_batches = len(shapes)
    queries = engine.encode(texts, is_query=True)
    main_launches = sa.launches
    hook.remove()
    n_batches = len(shapes)
    buckets = sorted({T for _, T in shapes})
    log(f"slice: {len(texts)} docs + {len(texts)} queries in {n_batches} batches, buckets {buckets}, "
        f"{n_trunc} docs truncated; K1 launches {main_launches}")
    assert main_launches == cfg.num_layers * n_batches > 0, \
        f"K1 launched {main_launches} times for {n_batches} batches of {cfg.num_layers} layers"
    assert {16, 32, 64, 128, 256, 300} <= set(buckets), buckets
    for name, emb in (("docs", docs), ("queries", queries)):
        assert emb.shape == (len(texts), cfg.hidden_size) and emb.dtype == np.float32, (name, emb.shape)
        assert np.isfinite(emb).all(), name
        norms = np.linalg.norm(emb, axis=1)
        assert np.abs(norms - 1).max() < 1e-2, (name, norms.min(), norms.max())
    assert np.abs(docs - queries).max() > 1e-3, "SPECB brackets did not change the embedding"
    perm = np.random.default_rng(SEED + 1).permutation(len(texts))
    shuffled = engine.encode([texts[i] for i in perm])
    cos = cosine(shuffled, docs[perm])
    log(f"shuffled input: min cosine to the unshuffled rows {cos.min():.6f}, "
        f"max abs diff {np.abs(shuffled - docs[perm]).max():.3e}")
    assert cos.min() > 0.999
    emb_per_s = len(texts) / doc_s
    tokens = sum(len(r) for r in engine.codec.encode_rows(texts)[0])
    log(f"encode: {emb_per_s:.1f} emb/s ({tokens / doc_s:.0f} tokens/s), "
        f"{len(texts)} docs in {doc_s:.3f} s, bf16, batch_size 64, max_seq_len 300 ({card})")

    # 4. card (kernel) against CPU (plain path) on the same weights
    idx = np.argsort([len(t) for t in texts])[:: len(texts) // 32][:32]
    small = [texts[i] for i in idx]
    cfg32 = gpt_neo("125m")
    cpu_model = Decoder(cfg32, generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model)
    kw = dict(specb=True, max_seq_len=300, batch_size=8, normalize_embeddings=True)
    on_cpu = EmbeddingEngine(cpu_model, cfg32, tok, device="cpu", **kw).encode(small)
    sa.launches = 0
    on_gpu = EmbeddingEngine(gpu_model, cfg32, tok, device="cuda", **kw).encode(small)
    assert sa.launches > 0
    err32 = np.abs(on_gpu - on_cpu).max()
    cos16 = cosine(docs[idx], on_cpu)
    log(f"parity fp32 card vs fp32 CPU, 32 texts: max abs diff {err32:.3e} (tolerance 1e-4)")
    log(f"parity bf16 card vs fp32 CPU, 32 texts: cosine min {cos16.min():.6f} "
        f"mean {cos16.mean():.6f} (tolerance min 0.99)")
    assert err32 < 1e-4
    assert cos16.min() > 0.99

    # 5. report
    log(card)
    print(json.dumps({"kernels": [{
        "name": "short_attention_fwd", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/short_attention.cu",
        "replaces": "sgpt_tpu/ops/pallas/short_attention.py:74",
        "launches": main_launches, "max_abs_err": main_err,
        "ms": times[0][0], "plain_ms": times[0][1],
        "ms_local256": times[256][0], "plain_ms_local256": times[256][1],
        "build_s": build_s, "encode_emb_per_s": emb_per_s}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
