"""One run of one cell: set up, measure a window, read the metrics, check the
window's outputs against the plain reference, print the result line.

Everything that belongs to one configuration, traffic mix, cell or metric is a
file found by name:

  BENCHMARK.json                  the cell: its configuration and traffic mix
  benchmark/configs/<config>.json the published widths and the served settings
  benchmark/traffic/<mix>.json    the mix's parameters and its `driver`
  benchmark/drivers/<driver>.py   the general generator and driver of one entry
  benchmark/workloads/<cell>.json the cell's check: its limits and parameters
  benchmark/metrics/<name>.py     a metric's reader; `a.b` falls back to `a.py`

Order of a run: set-up (weights from the seed, the program's objects, every
shape of the traffic warmed), the window (optionally under the profiler),
the peak memory read, the program's state freed, then the reference check.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

from . import tracing

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "sgpt_tpu")   # whole top-level names
CACHE = ROOT / "build" / "bench_cache"


def set_environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a library."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def foreign_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FOREIGN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration, mix and limits loaded."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = root / "benchmark"
    checks = load_json(bench / "workloads" / f"{name}.json")
    return {"entry": entry, "config": load_json(root / conf["file"]),
            "mix": load_json(bench / "traffic" / f"{entry['traffic']}.json"),
            "limits": checks["limits"], "check": checks.get("params", {})}


def driver_class(mix: dict):
    return importlib.import_module(f"benchmark.drivers.{mix['driver']}").Driver


def reader(name: str, root: Path = ROOT):
    """The metric's reader: metrics/<name>.py, else metrics/<stem>.py for a
    name `stem.suffix`."""
    d = root / "benchmark" / "metrics"
    path = d / f"{name}.py"
    if not path.exists():
        path = d / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list:
    """(name, unit) of the metrics this cell reports in this kind of run."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return [(m["name"], m["unit"]) for m in e2e]
    mine = {m["name"] for m in e2e}
    return [(m["name"], m["unit"]) for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def card(chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        info["power_limit"] = out.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = "unknown"
    return info


class SlotCounter:
    """Token slots the decoder is given while counting (B × T a forward),
    from a forward pre-hook: padding included."""

    def __init__(self, module):
        self.on, self.slots = False, 0
        self.handle = module.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        if self.on and args and hasattr(args[0], "numel"):
            self.slots += args[0].numel()

    def close(self):
        self.handle.remove()


def finite(x) -> Optional[float]:
    return float(x) if x is not None and math.isfinite(float(x)) else None


def run_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", root: Path = ROOT, spec: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. `spec` (a `cell()` result)
    replaces the files' (tests run tiny configurations on the CPU)."""
    import time

    import torch

    spec = spec or cell(manifest, name, root)
    drv = driver_class(spec["mix"])(spec["config"], spec["mix"], seed, device,
                                    check_params=spec["check"])
    drv.setup(seconds)
    slots = SlotCounter(drv.program_model)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    c0 = drv.counters()
    slots.on = True
    setup_s = time.perf_counter() - t_start
    with tracing.traced(trace) as prof:
        rec = drv.window(seconds)
        if on_card:
            torch.cuda.synchronize()
    slots.on = False
    c1 = drv.counters()
    dev = card(spec["entry"]["chips"]) if on_card else {"platform": "cpu", "kind": "cpu",
                                                       "count": 1}
    dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    summary = tracing.summarize(prof) if prof is not None else None
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
    run = {"kind": drv.kind, "setup_s": setup_s, "window_s": rec["window_s"],
           "latencies_ms": rec.get("latencies_ms"), "work": drv.work(rec),
           "slots": slots.slots, "counters": {k: c1[k] - c0[k] for k in c1}, "trace": summary}
    slots.close()
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check(rec)
    limits = spec["limits"]
    compared = {k: {"value": finite(checks[k]), "limit": lim} for k, lim in limits.items()}
    correct = (rec["failed"] == 0 and rec["attempted"] > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))
    metrics = {}
    for mname, unit in metrics_of(manifest, name, trace):
        v = reader(mname, root)(run)
        if v is not None:
            metrics[mname] = {"value": v, "unit": unit}
    out = {"correct": bool(correct), "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = summary["breakdown"]
    if "generator_late_ms" in rec:
        out["generator_late_ms"] = rec["generator_late_ms"]
    out["checks"] = compared
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    import time

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    manifest = load_json(ROOT / "BENCHMARK.json")
    spec = cell(manifest, args.workload)
    import torch

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                   spec=spec)
    bad = foreign_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr, flush=True)
    return 0
