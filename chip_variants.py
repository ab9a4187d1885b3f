#!/usr/bin/env python3
"""Build variants of K1's, K2's or K3's source on one NVIDIA card, check and time them in turns.

    python3 chip_variants.py [NAME ...]

Each variant is this tree's `sgpt_tpu_torch/csrc/short_attention.cu`,
`short_attention_bwd.cu` and `flash_attention.cu` and their headers with a
few text substitutions (VARIANTS below; "tree" is the source as it stands),
and names the kernel it is about: K1's fp32 forward (`tf32_kernel`), K2's
fp32 backward (`tf32_rows`, `tf32_cols`; `k2_p_probe` instead prints whether
both passes compute the same P bit for bit) or K3's fp32 forward
(`flash_fwd_tf32`, the `k3_` names). All variants build at once, one `nvcc`
each, into `build/variants/<name>/`; the port's wrappers then run on each
library in turn (`chip_smoke.kernels_of`). For every variant the script
prints the registers and spills of its kernels (K1, K2 at Dh=64 without
ALiBi or segments; K3 at Dh 64 and 128), the fp32 error against the plain
version with the fp32 gate (K1 over `chip_smoke.CASES`: |Δ| ≤ 1e-5 +
1e-5·|ref|; K2 over the same: |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| in dq, dk
and dv; K3 over `chip_smoke.FLASH_CASES`, output and lse: |Δ| ≤ 1e-5 +
1e-5·|ref|), and the time at the main path's shape over two rounds in
alternating order (K1, K2: the train shape B=32, T=300, H=12, Dh=64, fp32,
window 0 and 256, K2 also each pass alone under torch.profiler; K3: the
long train's B=8, T=2048, H=12, Dh=64, fp32, block_kv 256, window 0 and
256), beside SDPA fp32 (K2: SDPA's backward) and the card's name and power
limit. A variant is a measurement, never a second path: the tree keeps one
kernel.
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
    # K3: Q split once a block, each warp's A fragments held split in
    # registers across the walk (the tree splits them at every k-step)
    "k3_q_in_regs": [
        ("flash_attention.cu", "  for (int i = 0; i < n; ++i) {\n    const int entry = list[i], "
         "k0 = entry & ~NEEDS_MASK, stage = i & 1;\n    float* kb",
         "  uint32_t qf[D / 8][2][4];\n  for (int i = 0; i < n; ++i) {\n    const int entry = "
         "list[i], k0 = entry & ~NEEDS_MASK, stage = i & 1;\n    float* kb"),
        ("flash_attention.cu", "// K of sub-tile i (and at i = 0 the Q tile) landed and split\n",
         "// K of sub-tile i (and at i = 0 the Q tile) landed and split\n    if (i == 0)\n"
         "#pragma unroll\n      for (int d = 0; d < D / 8; ++d) a_frag_3xtf32<D>(qf[d][0], "
         "qf[d][1], qrows, d, lane);\n"),
        ("flash_attention.cu", "      uint32_t ab[4], as[4];\n      a_frag_3xtf32<D>(ab, as, "
         "qrows, d, lane);  // Q's fragments, split at every k-step\n      qk_step_3xtf32<D>(s, "
         "ab, as, kb, Ksm, d, lane);",
         "      qk_step_3xtf32<D>(s, qf[d][0], qf[d][1], kb, Ksm, d, lane);")],
    # K3: the fast exponential for p
    "k3_fast_exp": [("flash_attention.cu", "s[c][e] = expf(s[c][e] - m_new[e >> 1]);",
                     "s[c][e] = __expf(s[c][e] - m_new[e >> 1]);")],
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


def group(name: str) -> str:
    """The kernel a variant is about: "k2", "k3" or (the rest) "k1"."""
    return name[:2] if name[:3] in ("k2_", "k3_") else "k1"


def sources(name: str) -> list:
    """The sources a variant's library is built from: the kernel it is about
    (short_attention.cu also holds the error-string entry point)."""
    if name == "tree":
        return ["short_attention.cu", "short_attention_bwd.cu", "flash_attention.cu"]
    return {"k1": ["short_attention.cu"], "k2": ["short_attention.cu", "short_attention_bwd.cu"],
            "k3": ["short_attention.cu", "flash_attention.cu"]}[group(name)]


def build(names):
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in list(CSRC.glob("*.cuh")) + [CSRC / c for c in sources(name)]:
            text = f.read_text()
            for fname, old, new in VARIANTS[name]:
                if fname == f.name:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               *(str(d / c) for c in sources(name))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            for kernel, inst, args in (("tf32_kernel", "ILi64ELb0", "64, false"),
                                       ("tf32_rows", "ILi64ELb0", "64, false"),
                                       ("tf32_cols", "ILi64ELb0", "64, false"),
                                       ("flash_fwd_tf32", "ILi64E", "64"),
                                       ("flash_fwd_tf32", "ILi128E", "128")):
                if re.search(rf"Compiling entry function '.*{kernel}{inst}", line):
                    print(f"{name}: {kernel}<{args}>: "
                          + " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i_, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        if "short_attention_bwd.cu" in sources(name):
            lib.sgpt_short_attention_bwd.argtypes = [p] * 12 + [i_] * 4 + [f] + [i_] * 3 + [p]
            lib.sgpt_short_attention_bwd.restype = i_
        if "flash_attention.cu" in sources(name):
            lib.sgpt_flash_attention_fwd.argtypes = ([p] * 7 + [i_] * 4 + [ll] * 6 + [f]
                                                     + [i_] * 4 + [p])
            lib.sgpt_flash_attention_fwd.restype = i_
        lib.sgpt_short_attention_fwd.argtypes = [p] * 8 + [i_] * 4 + [f] + [i_] * 3 + [p]
        lib.sgpt_short_attention_fwd.restype = i_
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
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.ops import short_attention as sa

    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line(), flush=True)
    libs = build(names)
    k1 = {n: lib for n, lib in libs.items() if group(n) == "k1"}  # "tree" among them
    k2 = {n: lib for n, lib in libs.items()
          if n == "tree" or (group(n) == "k2" and n != "k2_p_probe")}
    k3 = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k3"}
    if len(k1) > 1 or names == ["tree"]:
        run_k1(torch, sa, k1)
    if len(k2) > 1 or names == ["tree"]:
        run_k2(torch, sa, k2)
    if len(k3) > 1 or names == ["tree"]:
        run_k3(torch, fa, k3)
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


def run_k3(torch, fa, libs):
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, Dh, block_kv, scale, window, alibi in cs.FLASH_CASES:
                B = min(B, 8)  # fp32 at the long train's batch, as phase flash takes it
                (q, k, v, km, slopes), _ = cs.attention_inputs(
                    torch, np.random.default_rng(len(case)), B, T, H, Dh, torch.float32,
                    alibi=alibi)
                slopes = slopes * 0.03 if alibi else None  # BLOOM-sized slopes
                qh, kh, vh = (cs.heads(t, H) for t in (q, k, v))
                kw = dict(scale=scale, window=window, block_kv=block_kv)
                got, lse = fa.flash_attention(qh, kh, vh, km, slopes, return_residuals=True,
                                              **kw)
                want, want_lse = fa.flash_attention_reference(qh, kh, vh, km, slopes, **kw)
                dead = want_lse == fa.NEG_INF
                err = (got - want).abs()
                lerr = (lse - want_lse).abs()[~dead]
                errs.append(f"{case} {err.max().item():.2e}/{lerr.max().item():.2e}")
                if (((err - cs.FP32_RTOL * want.abs()).max().item() > cs.FP32_ATOL)
                        or (lerr - cs.FP32_RTOL * want_lse.abs()[~dead]).max().item()
                        > cs.FP32_ATOL or not torch.equal(lse == fa.NEG_INF, dead)):
                    bad.append(case)
                del q, k, v, qh, kh, vh, got, want, lse, want_lse
        print(f"{name}: K3 fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"max |Δ| output/lse: {', '.join(errs)}", flush=True)
    (q, k, v, km, _), _ = cs.attention_inputs(torch, np.random.default_rng(cs.SEED), 8, 2048,
                                              12, 64, torch.float32)
    qh, kh, vh = (cs.heads(t, 12) for t in (q, k, v))
    for window in (0, 256):
        def run():
            return fa.flash_attention(qh, kh, vh, km, window=window, block_kv=256)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run, iters=10))
        mask = cs.sdpa_mask(torch, km, window)
        sdpa = cs.cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0), iters=5)
        print(f"K3 fp32 B=8 T=2048 window={window}: SDPA {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
            for n, t in times.items()), flush=True)
        del mask


if __name__ == "__main__":
    sys.exit(main())
