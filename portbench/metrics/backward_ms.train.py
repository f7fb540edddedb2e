"""backward_ms.train: device ms a training step of the operations launched
inside `train.backward` (the gradients, remat's recompute included), in the
profiled slice: their device time over the number of complete spans (one a
step)."""
from portbench.harness import spans


def read(ctx):
    s = spans.for_slice(ctx, "train")
    if s is None or not s.count("train.backward"):
        return None
    return s.device_ms("train.backward") / s.count("train.backward")
