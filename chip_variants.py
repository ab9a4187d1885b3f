#!/usr/bin/env python3
"""Build variants of K1's source on one NVIDIA card, check and time them in turns.

    python3 chip_variants.py [NAME ...]

Each variant is this tree's `sgpt_tpu_torch/csrc/short_attention.cu` and its
headers with a few text substitutions (VARIANTS below; "tree" is the source
as it stands). All variants build at once, one `nvcc` each, into
`build/variants/<name>/`; the port's wrappers then run on each library in
turn (`chip_smoke.kernels_of`). For every variant the script prints the
registers and spills of `tf32_kernel<64, false>`, K1's fp32 error against
the plain version over `chip_smoke.CASES` with the fp32 gate (|Δ| ≤ 1e-5 +
1e-5·|ref|), and the time at the train shape (B=32, T=300, H=12, Dh=64,
fp32; window 0 and 256) over two rounds in alternating order, beside SDPA
fp32 and the card's name and power limit. A variant is a measurement, never
a second path: the tree keeps one kernel.
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
VARIANTS = {  # name: [(file, text in the tree, its replacement)]
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
}


def build(names):
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in list(CSRC.glob("*.cuh")) + [CSRC / "short_attention.cu"]:
            text = f.read_text()
            for fname, old, new in VARIANTS[name]:
                if fname == f.name:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / "short_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if re.search(r"Compiling entry function '.*tf32_kernelILi64ELb0", line):
                print(f"{name}: tf32_kernel<64, false>: "
                      + " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i_, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
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
    from sgpt_tpu_torch.ops import short_attention as sa

    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line(), flush=True)
    libs = build(names)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
