"""mfu: the useful FLOPs of the window's real tokens (the decoder's weights
and causal attention pairs; for SGPT-CE also the LM head at the scored
tokens, `roofline.py`) over the window's length times the card's bf16
datasheet peak, 989 TFLOP/s at 700 W."""
from benchmark import roofline


def read(run):
    flops = run["work"].get("flops")
    if not flops or not run["trace"]:
        return None
    return 100.0 * flops / (run["window_s"] * roofline.PEAK_OPS_PER_S["bf16"])
