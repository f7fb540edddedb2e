"""mfu.gen: model FLOPs of the window's work over its seconds and the bf16
peak (989 TFLOP/s), %."""
from portbench.harness.stats import mfu


def read(ctx):
    return mfu(ctx, "gen")
