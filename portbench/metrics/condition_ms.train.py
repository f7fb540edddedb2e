"""condition_ms.train: device ms a training step of the operations launched
inside the control step's condition map (`train.condition`: Canny on the
device), in the profiled slice: their device time over the number of
complete spans (one a step)."""
from portbench.harness import spans


def read(ctx):
    s = spans.for_slice(ctx, "train")
    if s is None or not s.count("train.condition"):
        return None
    return s.device_ms("train.condition") / s.count("train.condition")
