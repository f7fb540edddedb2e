"""flash_train_roofline.train: the training-attention kernels' least time
(forward, dq and dk / dv launches, each bounded by its bf16 operations over
989 TFLOP/s or its bytes over 3.35 TB/s) over their device time in the
profiled slice, %."""
from portbench.harness.stats import train_roofline


def read(ctx):
    return train_roofline(ctx)
