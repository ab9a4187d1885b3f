"""k5_roofline: K5 (`ops/mips.py` → `csrc/mips.cu`), the least time its
launches in the window could take at the datasheet peaks (each reads the
index's rows once; `roofline.k5_bound_s`) over the device time of K5's
kernels in the trace."""
import re

from benchmark import roofline

K5 = re.compile(r"(?<![A-Za-z0-9_])(scan_mma|scan_simt|merge_kernel)\b")


def read(run):
    t, w = run["trace"], run["work"]
    launches = run["counters"].get("k5_launches")
    if not t or not launches or "index_rows" not in w:
        return None
    secs = sum(s for name, s in t["kernels"].items() if K5.search(name))
    if secs <= 0:
        return None
    bound = roofline.k5_bound_s(w["index_rows"], w["dim"], launches, w["queries"])
    return 100.0 * bound / secs
