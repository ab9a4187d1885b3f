"""The readings a cell's check limits are set from, on the card at the cell's
own size: the program's numbers on many seeds (the lower reading is their
largest) and the control's (the smallest is the upper reading). The control is
the program with its own int8 path switched on (`quantize="int8"`: int8
weights and activations), the nearest precision below the configuration's
bfloat16. Every seed builds the cell anew in this one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 \
        [--seconds 1] [--out FILE]

Prints one JSON line a seed: {"seed", "control", "checks", "attempted", "failed"}.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def readings(spec: dict, seed: int, control: bool, seconds: float, device="cuda") -> dict:
    """One seed's check numbers after a short window at the cell's load."""
    import torch

    drv = harness.driver_class(spec["mix"])(spec["config"], spec["mix"], seed, device,
                                            control=control, check_params=spec["check"])
    drv.setup(seconds)
    rec = drv.window(seconds)
    drv.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check(rec)
    del drv
    gc.collect()
    return {"seed": seed, "control": control, "checks": checks,
            "attempted": rec["attempted"], "failed": rec["failed"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    harness.set_environment()
    spec = harness.cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    out = open(args.out, "a") if args.out else None
    plan = [(int(s), False) for s in args.seeds.split(",") if s]
    plan += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        line = json.dumps({"workload": args.workload,
                           **readings(spec, seed, control, args.seconds)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
