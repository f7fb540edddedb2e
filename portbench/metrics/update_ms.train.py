"""update_ms.train: device ms a training step of the operations launched inside
`train.update` (frozen gradients zeroed, clip, AdamW, EMA), in the profiled
slice: their device time over the number of complete spans (one a step)."""
from portbench.harness import spans


def read(ctx):
    s = spans.for_slice(ctx, "train")
    if s is None or not s.count("train.update"):
        return None
    return s.device_ms("train.update") / s.count("train.update")
