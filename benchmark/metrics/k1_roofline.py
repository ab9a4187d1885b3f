"""k1_roofline: K1 (`ops/short_attention.py` → `csrc/short_attention.cu`),
the least time the window's real attention work could take at the datasheet
peaks (`roofline.k1_bound_s`) over the device time of K1's kernels in the
trace."""
import re

# K1's kernels: the bf16 tensor-core kernel, the fp32 ones and the scalar
# fallback (not PyTorch's compare_scalar_kernel)
K1 = re.compile(r"(?<![A-Za-z0-9_])(mma_kernel|tf32_kernel|tf32_kernel_wide|scalar_kernel)\b")


def read(run):
    t, bound = run["trace"], run["work"].get("k1_bound_s")
    if not t or not bound:
        return None
    secs = sum(s for name, s in t["kernels"].items() if K1.search(name))
    return 100.0 * bound / secs if secs > 0 else None
