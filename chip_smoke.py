#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`sgpt_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which asserts; any failure exits non-zero:
  1. build   — compile the CUDA kernels from `sgpt_tpu_torch/csrc/` with nvcc (sm_90a)
  2. kernel  — the fused short-T attention kernel (K1) against its plain
               PyTorch version on the card, at the encode path's shape and
               variants, and at the train slice's (fp32, B=32)
  3. bwd     — the short-attention backward kernel (K2) against its plain
               version, same variants, with a random output gradient
  4. slice   — bulk encode with full-width GPT-Neo-125M (random weights from a
               seed, bf16) through `EmbeddingEngine`, documents and queries;
               the kernel's launch count must be 12 × the number of batches
  5. parity  — the same weights in fp32 on the card (kernel) against fp32 on
               the CPU (plain path), and bf16-card against fp32-CPU cosines
  6. train   — MS MARCO contrastive training (SGPT-BE: BitFit, SPECB, MNRL,
               batch 32, max_seq_len 300, fp32) of full-width GPT-Neo-125M
               through `ContrastiveTrainer.fit`: K1 and K2 counted
               12 × 3 towers × steps, only biases move, the loss of a
               repeated batch falls, GradCache's loss equals the direct one
  7. tparity — one training step's loss and bias gradients, card against CPU
  8. report  — kernel and plain-version times, encode and train rates, the
               card's name and power limit, one `{"kernels": [...]}` line,
               and last `{"ok": true, "device": {...}}`

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


CASES = [  # name, B, T, H, Dh, scale, window, alibi, segments
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


def phase_kernel(torch, sa, rng):
    """K1 against its plain version; returns the main-path error and times."""
    main_err = 0.0
    for dtype, atol, rtol in ((torch.bfloat16, BF16_ATOL, BF16_RTOL),
                              (torch.float32, FP32_ATOL, FP32_RTOL)):
        for name, B, T, H, Dh, scale, window, alibi, segments in CASES:
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
    # the train slice's shape: fp32, B=32
    args, _ = attention_inputs(torch, rng, 32, 300, 12, 64, torch.float32)

    def kernel32():
        return sa.short_attention(*args, 1.0, 0, 12, False)

    def plain32():
        return sa.short_attention_reference(*args, scale=1.0, window=0, H=12, use_alibi=False)

    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain32, kernel32, kernel32, plain32))
    times["fp32"] = ((k1 + k2) / 2, (p1 + p2) / 2)
    log(f"time K1 B=32 T=300 H=12 Dh=64 fp32 window=0: kernel {times['fp32'][0]:.4f} ms, "
        f"plain {times['fp32'][1]:.4f} ms (runs: kernel {k1:.4f} {k2:.4f}, "
        f"plain {p1:.4f} {p2:.4f})")
    return main_err, times


def phase_bwd_kernel(torch, sa, rng):
    """K2 against its plain version over K1's variants (the main shapes at
    the train slice's B=32) with a random output gradient. fp32: only the
    summation order differs, |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref|; bf16: K1's
    2e-2 + 1e-2·|ref|. Returns the largest fp32 main-shape error (the train
    slice runs fp32) and the times at B=32, T=300, H=12, Dh=64."""
    main_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, T, H, Dh, scale, window, alibi, segments in CASES:
            B = 32 if name.startswith("main") else B
            args, extra = attention_inputs(torch, rng, B, T, H, Dh, dtype,
                                           alibi=alibi, segments=segments)
            g = torch.from_numpy(rng.normal(0.0, 1.0, (B, T, H * Dh)).astype(np.float32)
                                 ).to("cuda", dtype)
            kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, **extra)
            got = sa.short_attention_bwd(*args, g, **kw)
            want = sa.short_attention_bwd_reference(*args, g, **kw)
            torch.cuda.synchronize()
            errs = []
            for part, gg, ww in zip(("dq", "dk", "dv"), got, want):
                assert gg.shape == ww.shape and gg.dtype == ww.dtype == dtype, (name, part)
                gg, ww = gg.float(), ww.float()
                assert torch.isfinite(gg).all(), f"bwd {name} {part}: non-finite output"
                err = (gg - ww).abs()
                if dtype == torch.float32:
                    atol, rtol = FP32_ATOL * ww.abs().max().item(), FP32_RTOL
                else:
                    atol, rtol = BF16_ATOL, BF16_RTOL
                assert (err - rtol * ww.abs()).max().item() <= atol, \
                    f"bwd {name} {dtype} {part}: exceeds tolerance"
                errs.append(err.max().item())
                if name.startswith("main") and dtype == torch.float32:
                    main_err = max(main_err, err.max().item())
            log(f"bwd    {name:14s} {str(dtype)[6:]:8s} B={B} T={T} H={H} Dh={Dh} max_abs_err "
                f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}")

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 256):
            args, _ = attention_inputs(torch, rng, 32, 300, 12, 64, dtype)
            g = torch.from_numpy(rng.normal(0.0, 1.0, (32, 300, 768)).astype(np.float32)
                                 ).to("cuda", dtype)
            kw = dict(scale=1.0, window=window, H=12, use_alibi=False)

            def kernel():
                return sa.short_attention_bwd(*args, g, **kw)

            def plain():
                return sa.short_attention_bwd_reference(*args, g, **kw)

            p1, k1, k2, p2 = (cuda_ms(torch, f, iters=10) for f in (plain, kernel, kernel, plain))
            dt = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
            times[(dt, window)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            log(f"time K2 B=32 T=300 H=12 Dh=64 {dt} window={window}: kernel "
                f"{times[(dt, window)][0]:.4f} ms, plain {times[(dt, window)][1]:.4f} ms "
                f"(runs: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f})")
    return main_err, times


def synthetic_triplets(rng, n: int) -> list:
    """(query, positive, hard negative) triples: queries of 3-11 words,
    documents of 40-450 words, so that some truncate at 300 SPECB tokens."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [(text(3, 12), text(40, 451), text(40, 451)) for _ in range(n)]


def phase_train(torch, sa, rng, tok):
    """The train slice: the MS MARCO CLI's configuration (train_msmarco
    --train_batch_size 32 --specb --freezenonbias --lr 2e-4, max_seq_len 300,
    weightedmean, MNRL at scale 20, warmuplinear) on full-width
    GPT-Neo-125M in fp32, through `ContrastiveTrainer.fit`."""
    import dataclasses

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig

    steps, B = 5, 32
    cfg = gpt_neo("125m")
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    tc = TrainConfig(lr=2e-4, batch_size=B, max_seq_len=300, specb=True,
                     freeze_nonbias=True, pooling="weightedmean", scheduler="warmuplinear")
    triplets = synthetic_triplets(rng, B * (steps + 1))
    batches = [triplets[i * B:(i + 1) * B] for i in range(steps)]
    trainer = ContrastiveTrainer(model, cfg, tok, tc)
    _, n_trunc, _ = trainer.codec.encode_rows([t[1] for t in triplets])
    assert n_trunc > 0, "no document reached truncation"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.log_fn = lambda rec: stamps.append(time.perf_counter())  # float(loss) synchronises
    sa.launches = sa.bwd_launches = 0
    t0 = time.perf_counter()
    out = trainer.fit(lambda: iter(batches), steps_per_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = sa.launches, sa.bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in out["history"]]
    log(f"train: {steps} steps in {wall:.2f} s, losses {[round(x, 5) for x in losses]}, "
        f"{n_trunc} docs truncated; K1 launches {fwd_launches}, K2 launches {bwd_launches}")
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    want = cfg.num_layers * 3 * steps
    assert bwd_launches == want, f"K2 launched {bwd_launches} times, expected {want}"
    assert fwd_launches == want, f"K1 launched {fwd_launches} times, expected {want}"
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (name.rsplit(".", 1)[-1] in BIAS_NAMES), \
            f"{name}: {'moved' if moved else 'did not move'} under BitFit"
    intervals = np.diff(stamps)  # step 1 carries the first launches' set-up
    ms_per_step = 1e3 * float(np.median(intervals))
    seq_per_s = 3 * B / (ms_per_step / 1e3)

    # one batch repeated at a constant lr: the loss falls
    const = dataclasses.replace(tc, scheduler="constantlr", log_fn=None)
    rep = ContrastiveTrainer(model, cfg, tok, const).fit(
        lambda: iter([triplets[-B:]] * 4), steps_per_epoch=4)
    rep_losses = [h["loss"] for h in rep["history"]]
    log(f"train: one batch repeated at constant lr 2e-4: losses "
        f"{[round(x, 5) for x in rep_losses]}")
    assert rep_losses[-1] < rep_losses[0], rep_losses

    # one GradCache step (chunks of 8) against one direct step, same weights
    snap = {n: p.detach().clone() for n, p in model.state_dict().items()}
    direct = ContrastiveTrainer(model, cfg, tok, const).fit(
        lambda: iter([batches[0]]), steps_per_epoch=1)["history"][0]["loss"]
    model.load_state_dict(snap)
    sa.launches = sa.bwd_launches = 0
    gc = ContrastiveTrainer(model, cfg, tok, dataclasses.replace(
        const, use_gradcache=True, chunk_size=8)).fit(
        lambda: iter([batches[0]]), steps_per_epoch=1)["history"][0]["loss"]
    n_chunks = B // 8
    log(f"train: GradCache (chunk 8) loss {gc:.7f}, direct {direct:.7f}, "
        f"|diff| {abs(gc - direct):.3e}; K1 {sa.launches}, K2 {sa.bwd_launches} launches")
    assert abs(gc - direct) <= 1e-5 * abs(direct)
    assert sa.bwd_launches == cfg.num_layers * 3 * n_chunks
    assert sa.launches == 2 * cfg.num_layers * 3 * n_chunks  # pass 1 (no grad) and pass 2
    return {"ms_per_step": ms_per_step, "seq_per_s": seq_per_s, "peak_gib": peak_gib,
            "fwd_launches": fwd_launches, "bwd_launches": bwd_launches}


def phase_train_parity(torch, rng, tok):
    """One BitFit step on the same weights and batch (3 triplets, T=300,
    full width, fp32): the card (K1, K2) against the CPU (plain versions).
    Loss within 1e-5 relative; each bias gradient within 1e-4 of its
    leaf's norm."""
    import copy

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig

    cfg = gpt_neo("125m")
    cpu = Decoder(cfg, generator=torch.Generator().manual_seed(SEED + 1))
    gpu = copy.deepcopy(cpu).to("cuda")
    tc = TrainConfig(lr=2e-4, batch_size=3, max_seq_len=300, specb=True, freeze_nonbias=True)
    batch = synthetic_triplets(rng, 3)
    res = []
    for model in (cpu, gpu):
        trainer = ContrastiveTrainer(model, cfg, tok, tc)
        trainer._opt, trainer._sched = trainer._build_optimizer(1)
        loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
        res.append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()
                           if p.requires_grad}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = res
    worst = max(((g_gpu[n] - g).abs().max() / g.norm().clamp_min(1e-12)).item()
                for n, g in g_cpu.items())
    log(f"tparity: loss card {loss_gpu:.7f} CPU {loss_cpu:.7f} (|diff| "
        f"{abs(loss_gpu - loss_cpu):.3e}, tolerance 1e-5 relative); {len(g_cpu)} bias "
        f"gradients, worst max|diff|/norm {worst:.3e} (tolerance 1e-4)")
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    assert worst <= 1e-4


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

    # 2. K1 and 3. K2 against their plain versions
    rng = np.random.default_rng(SEED)
    main_err, times = phase_kernel(torch, sa, rng)
    bwd_err, bwd_times = phase_bwd_kernel(torch, sa, rng)

    # 4. the slice: full-width GPT-Neo-125M bulk encode through the engine
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

    # 5. card (kernel) against CPU (plain path) on the same weights
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

    # 6. the train slice, and 7. its card-against-CPU parity
    del model, engine, cpu_model, gpu_model
    torch.cuda.empty_cache()
    train = phase_train(torch, sa, rng, tok)
    phase_train_parity(torch, rng, tok)

    # 8. report
    log(f"train: {train['ms_per_step']:.1f} ms/step, {train['seq_per_s']:.1f} seq/s "
        f"(96 sequences per step), peak {train['peak_gib']:.2f} GiB, fp32, "
        f"batch 32, max_seq_len 300 ({card})")
    log(card)
    print(json.dumps({"kernels": [{
        "name": "short_attention_fwd", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/short_attention.cu",
        "replaces": "sgpt_tpu/ops/pallas/short_attention.py:74",
        "launches": main_launches + train["fwd_launches"],
        "launches_encode": main_launches, "launches_train": train["fwd_launches"],
        "max_abs_err": main_err,
        "ms": times[0][0], "plain_ms": times[0][1],
        "ms_local256": times[256][0], "plain_ms_local256": times[256][1],
        "ms_fp32_b32": times["fp32"][0], "plain_ms_fp32_b32": times["fp32"][1],
        "build_s": build_s, "encode_emb_per_s": emb_per_s}, {
        "name": "short_attention_bwd", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/short_attention_bwd.cu",
        "replaces": "sgpt_tpu/ops/pallas/short_attention.py:106",
        "launches": train["bwd_launches"], "max_abs_err": bwd_err,
        "ms": bwd_times[("fp32", 0)][0], "plain_ms": bwd_times[("fp32", 0)][1],
        **{f"{k}_{dt}_w{w}": bwd_times[(dt, w)][i] for dt, w in bwd_times
           for i, k in enumerate(("ms", "plain_ms"))},
        "train_ms_per_step": train["ms_per_step"], "train_seq_per_s": train["seq_per_s"],
        "train_peak_gib": train["peak_gib"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
