#!/usr/bin/env python3
"""Build variants of K1's or K2's source on one NVIDIA card, check and time them in turns.

    python3 chip_variants.py [NAME ...]

Each variant is this tree's `sgpt_tpu_torch/csrc/short_attention.cu` and
`short_attention_bwd.cu` and their headers with a few text substitutions
(VARIANTS below; "tree" is the source as it stands), and names the kernel it
is about: K1's fp32 forward (`tf32_kernel`) or K2's fp32 backward
(`tf32_rows`, `tf32_cols`; `k2_p_probe` instead prints whether both passes
compute the same P bit for bit). All variants build at once, one `nvcc` each,
into `build/variants/<name>/`; the port's wrappers then run on each library
in turn (`chip_smoke.kernels_of`). For every variant the script prints the
registers and spills of its kernels at Dh=64 without ALiBi or segments, the
fp32 error against the plain version over `chip_smoke.CASES` with the fp32
gate (K1: |Δ| ≤ 1e-5 + 1e-5·|ref|; K2: |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| in
dq, dk and dv), and the time at the train shape (B=32, T=300, H=12, Dh=64,
fp32; window 0 and 256) over two rounds in alternating order (K2: also each
pass alone, under torch.profiler), beside SDPA fp32 (K2: SDPA's backward)
and the card's name and power limit. A variant is a measurement, never a
second path: the tree keeps one kernel.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
from sgpt_tpu_torch.ops import _build

CSRC = Path("sgpt_tpu_torch/csrc")
OUT = Path("build/variants")
K2_EXP = [("short_attention_bwd.cu", f"expf(s[n][e] - {m})", f"__expf(s[n][e] - {m})")
          for m in ("m_new[e >> 1]", "m[r]", "qa->m[c]")]
VARIANTS = {  # name: [(file, text in the tree, its replacement)]; "k2_*": K2's
    "tree": [],
    # the rounding as the PTX instruction rather than two integer operations
    "cvt_rna": [("mma_tf32.cuh", "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x)); return r;')],
    # the three products of a step straight into the running sum
    "running_sum": [("mma_tf32.cuh", "float t[4] = {0.f, 0.f, 0.f, 0.f};", "float (&t)[4] = d;"),
                    ("mma_tf32.cuh", "for (int e = 0; e < 4; ++e) d[e] += t[e];",
                     "for (int e = 0; e < 0; ++e) d[e] += t[e];")],
    # one TF32 product (big parts only): the accuracy 3xTF32 buys
    "one_tf32": [("mma_tf32.cuh", "mma_tf32(t, as, bb0, bb1);\n  mma_tf32(t, ab, bs0, bs1);\n",
                  "")],
    # the fast exponential in the online softmax
    "fast_exp": [("short_attention.cu", "s[n][e] = expf(s[n][e] - m_new[e >> 1]);",
                  "s[n][e] = __expf(s[n][e] - m_new[e >> 1]);")],
    # K2: the fast exponential in both passes
    "k2_fast_exp": K2_EXP,
    # K2: one TF32 product (big parts only) in both passes
    "k2_one_tf32": [("mma_tf32.cuh", "mma_tf32(t, as, bb0, bb1);\n  mma_tf32(t, ab, bs0, bs1);\n",
                     ""),
                    ("mma_tf32.cuh", "mma_tf32(t, ab, bs0, bs1);\n  mma_tf32(t, as, bb0, bb1);\n",
                     "")],
    # K2, a probe (not timed): at T ≤ 64 and Dh = 64 the rows pass writes its
    # P into dq (row q, column key) and the cols pass its P into dk (row
    # key, column q), to see whether both passes compute the same P
    "k2_p_probe": [
        ("short_attention_bwd.cu", "s[n][e] = x * mask.scale;", "s[n][e] = p + 0.f * x;"),
        ("short_attention_bwd.cu",
         "pv_part_3xtf32<D, 4>(o, s, Kb + at * LD, Ksm + at * LD, lane);",
         "if constexpr (D == 64) for (int n = 0; n < 4; ++n) "
         "for (int e = 0; e < 4; ++e) o[(at >> 3) + n][e] = s[n][e];"),
        ("short_attention_bwd.cu", "pv_part_3xtf32<D, 4>(ak, dp, qb, qsm, lane);",
         "if constexpr (D == 64) for (int n = 0; n < 4; ++n) "
         "for (int e = 0; e < 4; ++e) ak[(c_at >> 3) + n][e] = s[n][e];")],
}


def build(names):
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in list(CSRC.glob("*.cuh")) + [CSRC / "short_attention.cu",
                                             CSRC / "short_attention_bwd.cu"]:
            text = f.read_text()
            for fname, old, new in VARIANTS[name]:
                if fname == f.name:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "short_attention.cu"), str(d / "short_attention_bwd.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            for kernel in ("tf32_kernel", "tf32_rows", "tf32_cols"):
                if re.search(rf"Compiling entry function '.*{kernel}ILi64ELb0", line):
                    print(f"{name}: {kernel}<64, false>: "
                          + " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i_, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sgpt_short_attention_fwd.argtypes = [p] * 8 + [i_] * 4 + [f] + [i_] * 3 + [p]
        lib.sgpt_short_attention_fwd.restype = i_
        lib.sgpt_short_attention_bwd.argtypes = [p] * 12 + [i_] * 4 + [f] + [i_] * 3 + [p]
        lib.sgpt_short_attention_bwd.restype = i_
        lib.sgpt_cuda_error_string.argtypes = [i_]
        lib.sgpt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from sgpt_tpu_torch.ops import short_attention as sa

    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line(), flush=True)
    libs = build(names)
    k1 = {n: lib for n, lib in libs.items() if not n.startswith("k2_")}  # K1's variants
    k2 = {n: lib for n, lib in libs.items()
          if n == "tree" or (n.startswith("k2_") and n != "k2_p_probe")}
    if len(k1) > 1 or names == ["tree"]:
        run_k1(torch, sa, k1)
    if len(k2) > 1 or names == ["tree"]:
        run_k2(torch, sa, k2)
    if "k2_p_probe" in libs:
        probe_p(torch, sa, libs["k2_p_probe"])
    return 0


def probe_p(torch, sa, lib):
    """Whether K2's two passes compute the same P bit for bit: the probe
    build writes the rows pass's P into dq and the cols pass's Pᵀ into dk
    (B=4, T=64, H=1, Dh=64, one tile each way)."""
    for case, window, alibi, segments in (("causal", 0, False, False),
                                          ("window16", 16, False, False),
                                          ("alibi-kpos", 0, True, False),
                                          ("segments", 0, False, True)):
        rng = np.random.default_rng(len(case))
        args, extra = cs.attention_inputs(torch, rng, 4, 64, 1, 64, torch.float32,
                                          alibi=alibi, segments=segments)
        g = torch.zeros_like(args[0])
        with cs.kernels_of(lib):
            p_rows, p_cols, _ = sa.short_attention_bwd(*args, g, scale=0.125, window=window,
                                                       H=1, use_alibi=alibi, **extra)
        torch.cuda.synchronize()
        p_cols = p_cols.transpose(1, 2)
        differ = int((p_rows != p_cols).sum().item())
        print(f"k2_p_probe {case}: P of the rows pass and of the cols pass differ in "
              f"{differ} of {p_rows.numel()} entries (max |Δ| "
              f"{(p_rows - p_cols).abs().max().item():.3e})", flush=True)


def run_k1(torch, sa, libs):
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, Dh, scale, window, alibi, segments in cs.CASES:
                args, extra = cs.attention_inputs(torch, np.random.default_rng(len(case)), B, T, H,
                                                  Dh, torch.float32, alibi=alibi,
                                                  segments=segments)
                got = sa.short_attention(*args, scale, window, H, alibi, **extra)
                want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                                    use_alibi=alibi, **extra)
                err = (got - want).abs()
                errs.append(f"{case} {err.max().item():.2e}")
                if ((err - cs.FP32_RTOL * want.abs()).max().item()) > cs.FP32_ATOL:
                    bad.append(case)
        print(f"{name}: fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"max |Δ|: {', '.join(errs)}", flush=True)
    args, _ = cs.attention_inputs(torch, np.random.default_rng(cs.SEED), 32, 300, 12, 64,
                                  torch.float32)
    q, k, v, km, _ = args
    qh, kh, vh = (cs.heads(t, 12) for t in (q, k, v))
    for window in (0, 256):
        def run():
            return sa.short_attention(*args, 1.0, window, 12, False)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run))
        mask = cs.sdpa_mask(torch, km, window)
        sdpa = cs.cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0))
        print(f"K1 fp32 B=32 T=300 window={window}: SDPA {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
            for n, t in times.items()), flush=True)


def run_k2(torch, sa, libs):
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, Dh, scale, window, alibi, segments in cs.CASES:
                rng = np.random.default_rng(len(case))
                args, extra = cs.attention_inputs(torch, rng, B, T, H, Dh, torch.float32,
                                                  alibi=alibi, segments=segments)
                g = torch.from_numpy(rng.normal(0.0, 1.0, (B, T, H * Dh)).astype(np.float32)
                                     ).cuda()
                kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, **extra)
                got = sa.short_attention_bwd(*args, g, **kw)
                want = sa.short_attention_bwd_reference(*args, g, **kw)
                worst = 0.0
                for gg, ww in zip(got, want):
                    err = (gg - ww).abs()
                    worst = max(worst, ((err - cs.FP32_RTOL * ww.abs()).max()
                                        / (cs.FP32_ATOL * ww.abs().max())).item())
                errs.append(f"{case} {worst:.2f}")
                if worst > 1:
                    bad.append(case)
        print(f"{name}: K2 fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"worst |Δ| − 1e-5·|ref| over 1e-5·max|ref|: {', '.join(errs)}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    args, _ = cs.attention_inputs(torch, rng, 32, 300, 12, 64, torch.float32)
    g = torch.from_numpy(rng.normal(0.0, 1.0, (32, 300, 768)).astype(np.float32)).cuda()
    q, k, v, km, _ = args
    for window in (0, 256):
        def run():
            return sa.short_attention_bwd(*args, g, scale=1.0, window=window, H=12,
                                          use_alibi=False)
        times = {name: [] for name in libs}
        passes = {}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run, iters=10))
                passes[name] = cs.pass_ms(torch, run)
        qh, kh, vh = (cs.heads(t, 12).detach().contiguous().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=cs.sdpa_mask(torch, km, window), scale=1.0)
        gh = cs.heads(g, 12).contiguous()
        sdpa = cs.cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                             retain_graph=True), iters=10)
        print(f"K2 fp32 B=32 T=300 window={window}: SDPA backward {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)}; rows pass "
            f"{passes[n][0]}, cols pass {passes[n][1]})" for n, t in times.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
