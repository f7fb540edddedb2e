"""flash_decode_roofline.gen: the decode-attention kernel's least time (its
bytes over 3.35 TB/s or fp32 operations over 67 TFLOP/s, per launch from the
slice's rows and positions) over its device time in the profiled slice, %."""
from portbench.harness.stats import decode_roofline


def read(ctx):
    return decode_roofline(ctx, "gen")
